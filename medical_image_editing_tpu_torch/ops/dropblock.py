"""DropBlock2D and its linear schedule.

Counterpart of `medical_image_editing_tpu/ops/dropblock.py` (reference
`src/networks/dropblock.py`, vendored from miguelvr/dropblock): seeds
Bernoulli(drop_prob / block_size²) per (sample, pixel), grown into blocks
by a stride-1 max-pool, the survivors rescaled by numel / sum of the keep
mask; the schedule steps drop_prob once per epoch
(`src/trainers/base.py:185-187`). NCHW.

The uniform draw is passed in, (B, 1, H, W) f32; the trainer draws it from
an explicit `torch.Generator` (`models.unet_decoder.sample_dropblock_draws`).
The arithmetic follows the JAX function's dtypes: the seeds, the keep mask,
its sum and the scale are in `x.dtype`, so in bf16 the scale rounds as JAX's
does.
"""

import numpy as np
import torch
import torch.nn.functional as F


def dropblock_schedule(epoch: int, start_value: float, stop_value: float,
                       nr_steps: int) -> float:
    """drop_prob of an epoch: linspace(start, stop, nr_steps)[min(epoch,
    nr_steps − 1)], in the JAX function's f32 arithmetic."""
    if nr_steps <= 1:
        return float(np.float32(start_value))
    i = np.float32(min(epoch, nr_steps - 1))
    f32 = np.float32
    return float(f32(start_value) + f32(stop_value - start_value) * i / f32(nr_steps - 1))


def dropblock_2d(x, drop_prob, block_size: int, uniform, train: bool = True):
    """x (B,C,H,W); `uniform` (B,1,H,W) in [0, 1). The mask is computed even
    at drop_prob 0, where it keeps everything, as the reference does."""
    if not train:
        return x
    h, w = x.shape[-2:]
    gamma = torch.tensor(drop_prob, dtype=torch.float32, device=x.device) / float(block_size**2)
    seeds = (uniform < gamma).to(x.dtype)
    # max_pool2d pads with −inf; an even block gives H + 1, trimmed to H
    pooled = F.max_pool2d(seeds, block_size, stride=1, padding=block_size // 2)
    keep = 1.0 - pooled[..., :h, :w]
    scale = torch.tensor(keep.numel(), dtype=x.dtype, device=x.device) / keep.sum().clamp_min(1.0)
    return x * keep * scale
