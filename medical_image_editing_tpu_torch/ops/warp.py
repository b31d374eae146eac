"""Invertible 2-D projective warps with explicit 3×3 matrices.

Counterpart of `medical_image_editing_tpu/ops/warp.py` (kornia
`warp_perspective` as the reference's `src/networks/random_transform.py:
76-112` uses it). A matrix maps *source* pixel coordinates (x, y, 1) to
*destination* ones; warping samples the source at M⁻¹·dst with zeros
outside the image. Pixel centres sit at integer coordinates
(align_corners=True); affine matrices turn about ((W−1)/2, (H−1)/2).

Sampling is the JAX function's own arithmetic, not `grid_sample`:
* nearest rounds half away from zero, as `lax.round` does (`grid_sample`
  rounds half to even), then masks coordinates outside the image;
* bilinear weighs the 2×2 neighbourhood (taps outside the image are 0) and
  masks points outside [-1, W] × [-1, H].
"""

import math

import torch


def identity_matrix(batch: int, device=None) -> torch.Tensor:
    return torch.eye(3, device=device).expand(batch, 3, 3)


def hflip_matrix(width: int, device=None) -> torch.Tensor:
    """x → (W−1) − x. Kornia's RandomHorizontalFlip transform."""
    return torch.tensor([[-1.0, 0.0, width - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                        device=device)


def affine_matrix(angle_deg, translate_xy, scale_xy, shear_deg_xy,
                  height: int, width: int) -> torch.Tensor:
    """Affine about the image centre, kornia `get_affine_matrix2d`
    semantics, batched: angle (B,), translate (B,2) pixels, scale (B,2),
    shear (B,2) degrees → (B,3,3)."""
    theta = angle_deg * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    sx, sy = scale_xy[:, 0], scale_xy[:, 1]
    shx = torch.tan(shear_deg_xy[:, 0] * (math.pi / 180.0))
    shy = torch.tan(shear_deg_xy[:, 1] * (math.pi / 180.0))
    rot = torch.stack([torch.stack([cos * sx, -sin * sy], -1),
                       torch.stack([sin * sx, cos * sy], -1)], -2)
    one = torch.ones_like(shx)
    shear = torch.stack([torch.stack([one, shx], -1), torch.stack([shy, one], -1)], -2)
    lin = rot @ shear
    center = torch.tensor([(width - 1) / 2.0, (height - 1) / 2.0], device=lin.device)
    offset = center + translate_xy - (lin @ center[:, None])[..., 0]
    m = torch.zeros(lin.shape[0], 3, 3, device=lin.device)
    m[:, :2, :2] = lin
    m[:, :2, 2] = offset
    m[:, 2, 2] = 1.0
    return m


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(v)
    return t + torch.sign(v) * ((v - t).abs() >= 0.5)


def warp_perspective(x: torch.Tensor, mats: torch.Tensor, method: str = "bilinear"):
    """Warp x (B,H,W,C) by per-sample src→dst matrices (B,3,3) → f32."""
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown warp method {method!r}")
    x = x.float()
    b, h, w, c = x.shape
    inv = torch.linalg.inv(mats.float())
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, :].expand(h, w)

    def row(i):
        return (inv[:, i, 0, None, None] * xs + inv[:, i, 1, None, None] * ys
                + inv[:, i, 2, None, None])

    den = row(2)
    sx, sy = row(0) / den, row(1) / den  # (B,H,W)
    flat = x.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    if method == "nearest":
        xi, yi = _round_half_away(sx), _round_half_away(sy)
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        v = gather(yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long())
        return torch.where(valid[..., None], v, torch.zeros((), device=x.device))

    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]

    def tap(yy, xx):
        inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        v = gather(yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long())
        return torch.where(inside[..., None], v, torch.zeros((), device=x.device))

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    out = (1.0 - wy) * ((1.0 - wx) * v00 + wx * v01) + wy * ((1.0 - wx) * v10 + wx * v11)
    valid = (sx >= -1.0) & (sx <= w) & (sy >= -1.0) & (sy <= h)
    return torch.where(valid[..., None], out, torch.zeros((), device=x.device))


def warp_ids_forward(ids: torch.Tensor, mats_list) -> torch.Tensor:
    """Re-apply recorded warps (in order, nearest) to an id map (B,H,W)."""
    x = ids.float()[..., None]
    for mats in mats_list:
        x = warp_perspective(x, mats, method="nearest")
    return x[..., 0]


def warp_ids_reverse(ids: torch.Tensor, mats_list) -> torch.Tensor:
    """Apply inverted warps in reverse order (nearest) to an id map (B,H,W)."""
    x = ids.float()[..., None]
    for mats in reversed(mats_list):
        x = warp_perspective(x, torch.linalg.inv(mats.float()), method="nearest")
    return x[..., 0]
