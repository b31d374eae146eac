"""Dual-view augmentation (the kornia RandomTransform replacement).

Counterpart of `medical_image_editing_tpu/ops/augment.py` (reference
`src/networks/random_transform.py`), in kornia 0.5.1 semantics:
geometric modules (RandomHorizontalFlip, RandomAffine) compose into one
src→dst matrix per sample, applied with one bilinear resample; photometric
modules (ColorJitter brightness/contrast, RandomGaussianBlur,
RandomPosterize, RandomGaussianNoise) act on the "noised" view only. Inputs
are (B,H,W,C) in [0,1].

Randomness is split from the arithmetic: `sample_view_draws` draws one
view's random numbers from a `torch.Generator`, and every other function
applies draws it is given. A view's draws are a dict with one entry per
configured module, in config order, under "geo" and "phot":
  RandomHorizontalFlip  geo  {"apply": (B,) bool}
  RandomAffine          geo  {"apply", "angle": (B,) degrees,
                              "translate": (B,2) in [-1,1] or None,
                              "scale": (B,) or None, "shear": (B,) degrees or None}
  ColorJitter           phot {"apply", "brightness": (B,1,1,1) or None,
                              "contrast": (B,1,1,1) or None}
  RandomGaussianBlur    phot {"apply"}
  RandomPosterize       phot {"apply"}
  RandomGaussianNoise   phot {"apply", "noise": (B,H,W,C) standard normal}
(None for a module of the other kind). The JAX functions draw the same
quantities from their key splits, which the tests replay.
"""

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .warp import affine_matrix, hflip_matrix, identity_matrix, warp_perspective


def _get(cfg: Any, name: str, default=None):
    """Read a field from a dict or namespace-style config."""
    if cfg is None:
        return default
    if isinstance(cfg, dict):
        return cfg.get(name, default)
    return getattr(cfg, name, default)


def _as_range(v, center: float = 0.0):
    """Kornia scalar→range convention: x → (center−x, center+x); pairs pass through."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return float(v[0]), float(v[1])
    return center - float(v), center + float(v)


def _modules(cfg):
    return list(_get(cfg, "modules", []) or [])


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def sample_view_draws(gen: torch.Generator, cfg, batch: int, height: int, width: int,
                      channels: int = 1) -> Dict[str, list]:
    """One view's draws (see the module docstring) from `gen`, on its device."""
    dev = gen.device

    def apply(mcfg):
        return torch.rand(batch, generator=gen, device=dev) < float(_get(mcfg, "p", 0.5))

    geo, phot = [], []
    for module in _modules(cfg):
        mcfg = _get(cfg, module)
        g = p = None
        if module == "RandomHorizontalFlip":
            g = {"apply": apply(mcfg)}
        elif module == "RandomAffine":
            deg_lo, deg_hi = _as_range(_get(mcfg, "degrees", 0.0))
            scale, shear = _get(mcfg, "scale"), _as_range(_get(mcfg, "shear"))
            g = {
                "apply": apply(mcfg),
                "angle": _uniform(gen, (batch,), deg_lo, deg_hi, dev),
                "translate": (_uniform(gen, (batch, 2), -1.0, 1.0, dev)
                              if _get(mcfg, "translate") is not None else None),
                "scale": (_uniform(gen, (batch,), float(scale[0]), float(scale[1]), dev)
                          if scale is not None else None),
                "shear": (_uniform(gen, (batch,), shear[0], shear[1], dev)
                          if shear is not None else None),
            }
        elif module == "ColorJitter":
            bright = float(_get(mcfg, "brightness", 0.0) or 0.0)
            contrast = float(_get(mcfg, "contrast", 0.0) or 0.0)
            p = {
                "apply": apply(mcfg),
                "brightness": (_uniform(gen, (batch, 1, 1, 1), -bright, bright, dev)
                               if bright > 0 else None),
                "contrast": (_uniform(gen, (batch, 1, 1, 1), max(0.0, 1.0 - contrast),
                                      1.0 + contrast, dev) if contrast > 0 else None),
            }
        elif module in ("RandomGaussianBlur", "RandomPosterize"):
            p = {"apply": apply(mcfg)}
        elif module == "RandomGaussianNoise":
            p = {"apply": apply(mcfg),
                 "noise": torch.randn((batch, height, width, channels), generator=gen,
                                      device=dev)}
        geo.append(g)
        phot.append(p)
    return {"geo": geo, "phot": phot}


def geometric_matrices(geo_draws, cfg, batch: int, height: int, width: int,
                       device=None) -> torch.Tensor:
    """The composed per-sample (B,3,3) geometric transform, modules in
    config order, each applied where its draw says so."""
    mats = identity_matrix(batch, device)
    eye = identity_matrix(batch, device)
    for module, d in zip(_modules(cfg), geo_draws):
        mcfg = _get(cfg, module)
        if module == "RandomHorizontalFlip":
            step = hflip_matrix(width, device).expand(batch, 3, 3)
        elif module == "RandomAffine":
            translate = _get(mcfg, "translate")
            if translate is not None:
                tx, ty = ((float(translate[0]), float(translate[1]))
                          if isinstance(translate, (tuple, list))
                          else (float(translate), float(translate)))
                trans = d["translate"] * torch.tensor([tx * width, ty * height],
                                                      device=device)
            else:
                trans = torch.zeros(batch, 2, device=device)
            s = d["scale"]
            scale = (torch.stack([s, s], -1) if s is not None
                     else torch.ones(batch, 2, device=device))
            shx = d["shear"]
            shear = (torch.stack([shx, torch.zeros_like(shx)], -1) if shx is not None
                     else torch.zeros(batch, 2, device=device))
            step = affine_matrix(d["angle"], trans, scale, shear, height, width)
        else:
            continue
        step = torch.where(d["apply"][:, None, None], step, eye)
        mats = step @ mats
    return mats


def _gaussian_blur(x, kernel: int, sigma: float):
    """Separable depthwise gaussian blur, reflect padding (kornia default)."""
    coords = torch.arange(kernel, dtype=torch.float32, device=x.device) - (kernel - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / g.sum()
    c = x.shape[-1]
    pad = kernel // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    out = F.conv2d(xp, g.view(1, 1, kernel, 1).expand(c, 1, kernel, 1), groups=c)
    out = F.conv2d(out, g.view(1, 1, 1, kernel).expand(c, 1, 1, kernel), groups=c)
    return out.permute(0, 2, 3, 1)


def apply_photometric(x: torch.Tensor, phot_draws, cfg) -> torch.Tensor:
    """Photometric modules in config order on x (B,H,W,C) in [0,1]."""
    for module, d in zip(_modules(cfg), phot_draws):
        mcfg = _get(cfg, module)
        if module == "ColorJitter":
            # kornia 0.5.1: additive brightness, pure-scaling contrast;
            # saturation and hue are no-ops on grayscale
            sel = x
            if d["brightness"] is not None:
                sel = (sel + d["brightness"]).clamp(0.0, 1.0)
            if d["contrast"] is not None:
                sel = (sel * d["contrast"]).clamp(0.0, 1.0)
        elif module == "RandomGaussianBlur":
            sel = _gaussian_blur(x, int(_get(mcfg, "kernel", 3)),
                                 float(_get(mcfg, "sigma", 1.0)))
        elif module == "RandomPosterize":
            levels = 2 ** (8 - int(_get(mcfg, "bits", 8)))
            sel = torch.floor(x * 255.0 / levels) * levels / 255.0
        elif module == "RandomGaussianNoise":
            sel = x + float(_get(mcfg, "std", 0.1)) * d["noise"]
        else:
            continue
        x = torch.where(d["apply"][:, None, None, None], sel, x)
    return x


def random_transform(image: torch.Tensor, cfg, draws) -> Tuple[torch.Tensor, ...]:
    """One augmented view from its draws: (noised, clear, mats). `clear` is
    the geometrically warped image before photometric noise; `mats` (B,3,3)
    is the composed geometric transform."""
    b, h, w, _ = image.shape
    mats = geometric_matrices(draws["geo"], cfg, b, h, w, image.device)
    clear = warp_perspective(image, mats, method="bilinear")
    return apply_photometric(clear, draws["phot"], cfg), clear, mats


def cross_view_transform(ids: torch.Tensor, mats_src: torch.Tensor,
                         mats_dst: torch.Tensor) -> torch.Tensor:
    """Warp an id map (B,H,W) from view-src's frame into view-dst's in one
    nearest resample (matrix mats_dst · mats_src⁻¹) → f32 ids."""
    m = mats_dst.float() @ torch.linalg.inv(mats_src.float())
    return warp_perspective(ids.float()[..., None], m, method="nearest")[..., 0]
