"""Primitive network blocks, NCHW with OIHW weights.

Counterpart of `medical_image_editing_tpu/models/blocks.py` (reference
`src/networks/blocks.py`, `src/networks/aspp.py`). Submodule names follow
the reference's torch state-dict keys (`double_conv.0`, `downsample.0`,
`norm1.param_free_norm`, `stages.c0.conv`, ...), which are also the keys the
JAX package's `utils/torch_export.py` writes.

* Convolutions are plain `nn.Conv2d` with SAME padding; the JAX package's
  packed-conv hook (`MEDIMG_CONV_IMPL=packed`) is off its default path.
* InstanceNorm is the two-pass form `F.instance_norm` computes (biased
  variance, eps 1e-5, no affine). The JAX package's five `MEDIMG_IN_IMPL`
  variants are TPU layout forms of this one function.
* `StyledDenorm`'s parameter-free BatchNorm uses its stored running mean and
  variance as they are: the port serves, so its modules run in eval mode.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vq import VQModule


def seeded_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of `module` (on the CPU) from
    `generator`, in module order: convs get torch's default
    uniform(±1/√fan_in) weight and bias, BatchNorm running stats are reset,
    codebooks are drawn random-normal."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
        elif isinstance(m, VQModule):
            m.reset_parameters(generator)
    return module


def conv3x3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel normalization over H,W (NCHW); no affine."""
    return F.instance_norm(x, eps=eps)


def nearest_upsample(x, factor: int = 2):
    """`nn.Upsample(scale_factor=2, mode='nearest')`."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def pixel_shuffle(x, factor: int = 2):
    """`nn.PixelShuffle`: (B,C·r²,H,W) → (B,C,H·r,W·r), torch (C,r,r) order."""
    return F.pixel_shuffle(x, factor)


def max_pool_2x2(x):
    """`nn.MaxPool2d(2)`."""
    return F.max_pool2d(x, 2)


class DoubleConv(nn.Module):
    """(Conv3×3 → IN → ReLU) ×2; without the output act the second IN+ReLU
    is dropped. Keys `double_conv.0` / `double_conv.3`."""

    def __init__(self, cin: int, features: int, use_output_act: bool = True):
        super().__init__()
        layers = [conv3x3(cin, features), nn.InstanceNorm2d(features), nn.ReLU(),
                  conv3x3(features, features)]
        if use_output_act:
            layers += [nn.InstanceNorm2d(features), nn.ReLU()]
        self.double_conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.double_conv(x)


class ResBlock(nn.Module):
    """DoubleConv + (1×1 conv, IN) identity, ReLU; returns (maxpooled, skip)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, features, 1, bias=False), nn.InstanceNorm2d(features)
        )
        self.double_conv = DoubleConv(cin, features)

    def forward(self, x):
        out = F.relu(self.double_conv(x) + self.downsample(x))
        return max_pool_2x2(out), out


class UpBlock(nn.Module):
    """Nearest-upsample + concat skip + DoubleConv."""

    def __init__(self, cin: int, features: int, use_output_act: bool = True):
        super().__init__()
        self.double_conv = DoubleConv(cin, features, use_output_act)

    def forward(self, down_input, skip_input):
        x = torch.cat([nearest_upsample(down_input), skip_input], dim=1)
        return self.double_conv(x)


class StyledDenorm(nn.Module):
    """SPADE denormalization: parameter-free BatchNorm modulated by γ,β
    computed from the style tensor."""

    def __init__(self, features: int, style_channels: int):
        super().__init__()
        self.param_free_norm = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1,
                                              affine=False)
        self.mlp_shared = nn.Sequential(conv3x3(style_channels, features), nn.ReLU())
        self.mlp_gamma = conv3x3(features, features)
        self.mlp_beta = conv3x3(features, features)

    def forward(self, x, style):
        normalized = self.param_free_norm(x)
        actv = self.mlp_shared(style)
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class StyledResUpBlock(nn.Module):
    """Upsample (nearest, or conv + PixelShuffle) then two styled conv-norms
    with a plain conv-IN-ReLU residual; the skip is the SPADE style."""

    def __init__(self, cin: int, features: int, style_channels: int,
                 use_output_act: bool = True, use_pixel_shuffle: bool = False):
        super().__init__()
        self.use_output_act = use_output_act
        if use_pixel_shuffle:
            self.up_sample = nn.Sequential(conv3x3(cin, cin * 4), nn.PixelShuffle(2))
        else:
            self.up_sample = None
        self.conv = nn.Sequential(conv3x3(cin, features),
                                  nn.InstanceNorm2d(features), nn.ReLU())
        self.conv1 = conv3x3(cin, features)
        self.norm1 = StyledDenorm(features, style_channels)
        self.conv2 = conv3x3(features, features)
        self.norm2 = StyledDenorm(features, style_channels)

    def forward(self, down_input, skip_input):
        if self.up_sample is not None:
            x = self.up_sample(down_input)
        else:
            x = nearest_upsample(down_input)
        s = self.conv(x)
        x = F.relu(self.norm1(self.conv1(x), skip_input))
        x = self.norm2(self.conv2(x), skip_input)
        if self.use_output_act:
            x = F.relu(x)
        return s + x


class _ASPPStage(nn.Module):
    """Conv (bias-free) → IN → ReLU; key `conv`."""

    def __init__(self, cin: int, features: int, rate: int):
        super().__init__()
        if rate == 0:
            self.conv = nn.Conv2d(cin, features, 1, bias=False)
        else:
            self.conv = nn.Conv2d(cin, features, 3, padding=rate, dilation=rate,
                                  bias=False)

    def forward(self, x):
        return F.relu(instance_norm(self.conv(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1×1 stage and one dilated 3×3 stage
    per rate (explicit padding = rate), concatenated on channels.
    Keys `stages.c0` (1×1), `stages.c1`… (dilated)."""

    def __init__(self, cin: int, features: int, rates=(2, 6, 12, 18)):
        super().__init__()
        self.stages = nn.ModuleDict(
            {f"c{i}": _ASPPStage(cin, features, r) for i, r in enumerate((0, *rates))}
        )

    def forward(self, x):
        return torch.cat([stage(x) for stage in self.stages.values()], dim=1)
