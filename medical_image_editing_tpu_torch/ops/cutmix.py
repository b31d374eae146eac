"""CutMix box sampling and pasting for the second stage's discriminator.

Counterpart of `medical_image_editing_tpu/ops/cutmix.py` (reference
`src/utils/__init__.py:192-218`, `cutmix_coordinates` / `cutmix` /
`mask_src_tgt`). The box stays on the device as int32 corner tensors and
becomes an (H,W) {0,1} mask built from comparisons with `arange`, as the
JAX package builds it from iota: no corner is read back to the host, so a
step never waits on `.item()`. Pasting is a lerp by the mask.

Layouts are NCHW, the port's modules' layout (the JAX functions take NHWC):
a 2-D mask broadcasts over batch and channels.
"""

from typing import Tuple

import torch

Box = Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def cutmix_coordinates(generator: torch.Generator, height: int, width: int,
                       alpha: float = 1.0) -> Tuple[Box, torch.Tensor]:
    """Box corners ((y0, y1), (x0, x1)) as int32 0-d tensors and lam, drawn
    from `generator` on its device: lam ~ Beta(alpha, alpha), the centre
    uniform over the image, sides √(1 − lam) of the image's, clipped to it.
    Only alpha 1 is taken (the only value any caller uses): Beta(1, 1) is a
    uniform draw, which the generator gives; `torch.distributions.Beta`
    takes no generator, and a draw outside it would break a resumed run's
    replay."""
    if alpha != 1.0:
        raise ValueError(f"cutmix_coordinates takes alpha 1 only (Beta(1, 1) = uniform), "
                         f"got {alpha}")
    lam, ux, uy = torch.rand(3, generator=generator, device=generator.device)
    return cutmix_box(lam, ux, uy, height, width), lam


def cutmix_box(lam, ux, uy, height: int, width: int) -> Box:
    """The box of `cutmix_coordinates` from its draws (f32 0-d tensors):
    lam, and the centre's uniforms ux, uy in [0, 1)."""
    cx, cy = ux * width, uy * height
    w = width * torch.sqrt(1.0 - lam)
    h = height * torch.sqrt(1.0 - lam)
    x0 = torch.round(torch.clamp(cx - w / 2, min=0.0)).to(torch.int32)
    x1 = torch.round(torch.clamp(cx + w / 2, max=float(width))).to(torch.int32)
    y0 = torch.round(torch.clamp(cy - h / 2, min=0.0)).to(torch.int32)
    y1 = torch.round(torch.clamp(cy + h / 2, max=float(height))).to(torch.int32)
    return (y0, y1), (x0, x1)


def cutmix_mask(coords: Box, height: int, width: int, dtype=torch.float32) -> torch.Tensor:
    """Box corners → (H,W) mask on the corners' device, 1 inside
    [y0,y1)×[x0,x1) (python-slice semantics)."""
    (y0, y1), (x0, x1) = coords
    y0 = torch.as_tensor(y0)
    rows = torch.arange(height, device=y0.device)[:, None]
    cols = torch.arange(width, device=y0.device)[None, :]
    inside = (rows >= y0) & (rows < torch.as_tensor(y1)) \
        & (cols >= torch.as_tensor(x0)) & (cols < torch.as_tensor(x1))
    return inside.to(dtype)


def cutmix(source: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Paste `target` into `source` inside the box: (B,C,H,W) each, mask
    (H,W) from `cutmix_mask`."""
    m = mask[None, None]
    return source * (1.0 - m) + target * m


def mask_src_tgt(source: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lerp by mask: source·m + (1 − m)·target; an (H,W) mask broadcasts
    over (B,C)."""
    m = mask[None, None] if mask.ndim == 2 else mask
    return source * m + (1.0 - m) * target
