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
The final tanh runs in f32. DropBlock acts only in training and is not
ported yet.
"""

from typing import Sequence

import torch
from torch import nn

from .blocks import ASPP, DoubleConv, ResBlock, StyledResUpBlock, conv3x3


class UNetDecoder(nn.Module):
    """embedding (B,in,H,W) → image (B,out,H,W) in [-1,1]."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 dropped_skip_layers: Sequence[int] = (5, 6),
                 use_pixel_shuffle: bool = True,
                 use_last_pixel_shuffle: bool = False):
        super().__init__()
        f = list(filters)
        n = len(f) - 1
        self.n_levels = n
        self.dropped_skip_layers = tuple(dropped_skip_layers)
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
            for level in range(1, n):
                setattr(self, f"pixel_shuffle2_{level + 1}", nn.Sequential(
                    conv3x3(f[level], (4**level) * f[0]), nn.PixelShuffle(2**level)))
            self.conv_last = nn.Conv2d(n * f[0], out_channels, 1)
        else:
            self.conv_last = nn.Sequential(ASPP(f[0], f[0]), DoubleConv(5 * f[0], f[0]))
            self.conv1x1 = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
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
