"""SPADE-styled U-Net decoder reconstructing the image from the quantized
full-resolution embedding.

Counterpart of `medical_image_editing_tpu/models/unet_decoder.py`
(reference `src/networks/unet_decoder.py`): a second U-Net that re-encodes
the embedding down 4 levels and decodes with `StyledResUpBlock`s whose skip
connections are the SPADE style; `dropped_skip_layers` zeroes selected skips
(0 = deepest). Two heads:
  * default: residual ASPP head — `out = x + DoubleConv(ASPP(x))`, 1×1 conv
    (keys `conv_last.0` ASPP, `conv_last.1` DoubleConv, `conv1x1`);
  * `use_last_pixel_shuffle`: every up-level output PixelShuffled to full
    resolution and concatenated before a 1×1 conv (keys
    `pixel_shuffle2_{level+1}.0`, `conv_last`).
The final tanh runs in f32. `dtype` is the compute dtype, as the JAX
module's (see `blocks.py`); the `StyledDenorm` BatchNorms follow the
module's train/eval mode. With `use_dropblock`, DropBlock
(`ops/dropblock.py`, `block_size`) acts on each skip not in
`dropped_skip_layers`, in training only: the forward takes `drop_prob` and
one uniform draw per such skip (`sample_dropblock_draws`), where the JAX
module draws from its 'dropblock' RNG stream. In eval mode it is the
identity and takes no draws.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops.dropblock import dropblock_2d
from .blocks import (
    ASPP,
    Conv,
    DoubleConv,
    ResBlock,
    StyledResUpBlock,
    conv3x3,
    set_compute_dtype,
)


class UNetDecoder(nn.Module):
    """embedding (B,in,H,W) → image (B,out,H,W) in [-1,1]."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 use_dropblock: bool = False, block_size: int = 30,
                 dropped_skip_layers: Sequence[int] = (5, 6),
                 use_pixel_shuffle: bool = True,
                 use_last_pixel_shuffle: bool = False, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        f = list(filters)
        n = len(f) - 1
        self.n_levels = n
        self.dropped_skip_layers = tuple(dropped_skip_layers)
        self.use_dropblock = bool(use_dropblock)
        self.block_size = int(block_size)
        self.use_last_pixel_shuffle = bool(use_last_pixel_shuffle)
        cin = in_channels
        for i in range(n):
            setattr(self, f"down_conv2_{i + 1}", ResBlock(cin, f[i]))
            cin = f[i]
        self.double_conv2 = DoubleConv(f[n - 1], f[n])
        for level in reversed(range(n)):
            setattr(self, f"up_conv2_{level + 1}", StyledResUpBlock(
                f[level + 1], f[level], f[level],
                use_pixel_shuffle=bool(use_pixel_shuffle)))
        if self.use_last_pixel_shuffle:
            # flax's own nn.Conv in the JAX module: never dispatched
            for level in range(1, n):
                setattr(self, f"pixel_shuffle2_{level + 1}", nn.Sequential(
                    conv3x3(f[level], (4**level) * f[0], packable=False),
                    nn.PixelShuffle(2**level)))
            self.conv_last = Conv(n * f[0], out_channels, 1)
        else:
            self.conv_last = nn.Sequential(ASPP(f[0], f[0]), DoubleConv(5 * f[0], f[0]))
            self.conv1x1 = Conv(f[0], out_channels, 1)
        set_compute_dtype(self, dtype)

    def dropblock_levels(self) -> List[int]:
        """The up levels i (0 = deepest skip) whose skip DropBlock acts on."""
        return [i for i in range(self.n_levels) if i not in self.dropped_skip_layers]

    def forward(self, x, drop_prob=0.0, dropblock_draws: Optional[Sequence] = None):
        """`dropblock_draws`: with `use_dropblock`, in training, one
        (B, 1, H_i, W_i) uniform per level of `dropblock_levels()`, in that
        order."""
        dropblock = self.use_dropblock and self.training
        if dropblock:
            if dropblock_draws is None:
                raise ValueError("use_dropblock in training needs dropblock_draws "
                                 "(sample_dropblock_draws)")
            draws = dict(zip(self.dropblock_levels(), dropblock_draws))
        x = x.to(self.compute_dtype or x.dtype)
        n = self.n_levels
        skips = []
        for i in range(n):
            x, skip = getattr(self, f"down_conv2_{i + 1}")(x)
            skips.append(skip)
        x = self.double_conv2(x)
        skips.reverse()

        outs = []
        for i in range(n):
            skip = skips[i]
            if i in self.dropped_skip_layers:
                skip = torch.zeros_like(skip)
            elif dropblock:
                skip = dropblock_2d(skip, drop_prob, self.block_size, draws[i])
            level = n - 1 - i
            x = getattr(self, f"up_conv2_{level + 1}")(x, skip)
            if self.use_last_pixel_shuffle:
                outs.append(getattr(self, f"pixel_shuffle2_{level + 1}")(x)
                            if level > 0 else x)

        if self.use_last_pixel_shuffle:
            out = self.conv_last(torch.cat(outs[::-1], dim=1))
        else:
            out = self.conv1x1(x + self.conv_last(x))
        return torch.tanh(out.float())


def sample_dropblock_draws(generator: torch.Generator, decoder: UNetDecoder, batch: int,
                           height: int, width: int) -> Optional[List[torch.Tensor]]:
    """One (B, 1, H_i, W_i) f32 uniform per level of `decoder.dropblock_levels()`
    for an embedding of (height, width), drawn from `generator` on its
    device (level i's skip is at 1/2^(n−1−i) of the input's resolution);
    None, drawing nothing, without `use_dropblock`. A training step draws
    them whatever its `drop_prob`, so the generator's stream does not
    depend on the schedule."""
    if not decoder.use_dropblock:
        return None
    n = decoder.n_levels
    return [torch.rand((batch, 1, height >> (n - 1 - i), width >> (n - 1 - i)),
                       generator=generator, device=generator.device)
            for i in decoder.dropblock_levels()]
