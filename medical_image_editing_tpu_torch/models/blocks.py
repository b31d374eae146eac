"""Primitive network blocks, NCHW with OIHW weights.

Counterpart of `medical_image_editing_tpu/models/blocks.py` (reference
`src/networks/blocks.py`, `src/networks/aspp.py`). Submodule names follow
the reference's torch state-dict keys (`double_conv.0`, `downsample.0`,
`norm1.param_free_norm`, `stages.c0.conv`, ...), which are also the keys the
JAX package's `utils/torch_export.py` writes.

* Every convolution is a `Conv`: an `nn.Conv2d` (same parameters and keys)
  with flax's compute-dtype semantics and the JAX package's packed-conv
  dispatch. Under `MEDIMG_CONV_IMPL=packed` the convolutions that JAX's
  `_conv_dispatch` admits (3×3 SAME stride 1, undilated, one group,
  W % 4 == 0, gcd(H, 64) ≥ 8, Cin == 32, input dtype equal to weight dtype)
  go through `ops/conv_pack.py`'s kernel with its analytic backward, the
  bias added afterwards; everything else goes to `F.conv2d`. While
  `torch.export` traces (`torch.compiler.is_exporting()`), a routed
  convolution calls the kernel's operator `medimg::conv3x3_packed`
  instead, which has no gradient: the exported program holds one node a
  routed convolution, and the route, read from `MEDIMG_CONV_IMPL` at
  trace time, is fixed in it. Inside
  `ops/quantized_conv.py::quantize_convs("int8")` every `Conv` (the
  `packable=False` ones too, as the JAX package intercepts every flax
  `nn.Conv`) runs `int8_conv` on its f32 weight and bias instead, its
  output in the compute dtype (f32 when none).
* Compute dtype, as flax's `dtype=`: parameters stay float32; a convolution
  casts its input, weight and bias to the compute dtype (by default the
  promotion of input and weight dtypes) and returns that dtype; norm
  statistics are reduced in float32 and the result is cast back to the
  input's dtype. `set_compute_dtype` sets it on every `Conv` of a module.
* InstanceNorm is the two-pass form `F.instance_norm` computes (biased
  variance, eps 1e-5, no affine). The JAX package's five `MEDIMG_IN_IMPL`
  variants are TPU layout forms of this one function.
* `StyledDenorm`'s parameter-free BatchNorm (and, with scale and bias, the
  PatchGAN discriminator's) is flax's `nn.BatchNorm(momentum=0.9)`: in
  train mode it normalises with the batch statistics (fast variance
  E[x²] − E[x]², clipped at 0) and moves the running stats
  by 0.1 towards them, with the *biased* variance, where torch's
  `BatchNorm2d` would store the unbiased one; in eval mode it uses the
  running stats. With `axis_name` (`parallel.DATA_AXIS`, set at
  construction as flax's `axis_name`) the train-mode mean and mean of
  squares are averaged over the ranks of the process group in one
  all-reduce that autograd carries back (flax's `lax.pmean` and its
  transpose): the synced statistics normalise the batch and move the
  running stats.
"""

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_pack import conv3x3_packed_op, conv3x3_packed_trainable_nchw, packed_eligible
from ..ops.quantized_conv import int8_conv, quantize_mode
from ..ops.vq import VQModule
from ..parallel.mesh import pmean_differentiable


def conv_impl() -> str:
    """The convolution route, read per call as the JAX package reads it:
    `MEDIMG_CONV_IMPL` ("xla", the default, or "packed")."""
    return os.environ.get("MEDIMG_CONV_IMPL", "xla")


def seeded_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of `module` (on the CPU) from
    `generator`, in module order: convs (2-D and 3-D) get torch's default
    uniform(±1/√fan_in) weight and bias, BatchNorm running stats are reset,
    codebooks are drawn random-normal."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
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


class Conv(nn.Conv2d):
    """`nn.Conv2d` with a compute dtype and the packed-conv dispatch.
    `packable=False` marks the convolutions the JAX package builds with
    flax's own `nn.Conv`, which never dispatch."""

    def __init__(self, *args, packable: bool = True, **kw):
        super().__init__(*args, **kw)
        self.packable = packable
        self.compute_dtype = None

    def _cast(self, x):
        """x, weight and bias in the compute dtype."""
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt)

    def _eligible(self, x: torch.Tensor, w: torch.Tensor) -> bool:
        b, c, h, wd = x.shape
        return (self.packable and conv_impl() == "packed"
                and self.padding_mode == "zeros" and tuple(self.padding) == (1, 1)
                and x.dtype == w.dtype
                and packed_eligible((b, h, wd, c), self.kernel_size, tuple(self.stride),
                                    "SAME", tuple(self.dilation), self.groups))

    def routes_to_kernel(self, x: torch.Tensor) -> bool:
        """Whether a call on x (NCHW) goes to the packed kernel, as JAX's
        `_conv_dispatch` would send it to its Pallas kernel."""
        return self._eligible(*self._cast(x)[:2])

    def forward(self, x):
        if quantize_mode() == "int8":
            if torch.compiler.is_exporting():
                raise NotImplementedError("the int8 decode is not exported (neither is the "
                                          "JAX package's)")
            if self.padding_mode != "zeros":
                raise ValueError(f"int8_conv pads with zeros, not {self.padding_mode!r}")
            return int8_conv(x, self.weight, self.bias, stride=self.stride,
                             padding=self.padding, dilation=self.dilation, groups=self.groups,
                             out_dtype=self.compute_dtype or torch.float32)
        x, w, b = self._cast(x)
        if self._eligible(x, w):
            if torch.compiler.is_exporting():
                y = conv3x3_packed_op(x, w)
            else:
                y = conv3x3_packed_trainable_nchw(x, w)
            return y if b is None else y + b[:, None, None]
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation, self.groups)


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of every `Conv` in `module` (None: promote)."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.compute_dtype = dtype
    return module


def conv3x3(cin: int, cout: int, bias: bool = True, packable: bool = True) -> Conv:
    return Conv(cin, cout, 3, padding=1, bias=bias, packable=packable)


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel normalization over H,W (NCHW); no affine;
    statistics in float32, result in x.dtype."""
    return F.instance_norm(x.float(), eps=eps).to(x.dtype)


class InstanceNorm(nn.Module):
    """`instance_norm` as a module (no parameters, no state-dict keys)."""

    def forward(self, x):
        return instance_norm(x)


class FlaxBatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9)` under torch's `BatchNorm2d`
    parameter and buffer names (see the module docstring); `affine` adds
    flax's scale and bias (`weight`, `bias`); `axis_name` syncs the batch
    statistics over the ranks."""

    FLAX_MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 axis_name=None):
        super().__init__(features, eps=eps, affine=affine)
        self.axis_name = axis_name

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, mean2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
            if self.axis_name is not None:
                mean, mean2 = pmean_differentiable([mean, mean2])
            var = (mean2 - mean * mean).clamp_min(0.0)
            m = self.FLAX_MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.affine:  # flax's order: (x − mean)·(rsqrt(var + eps)·scale) + bias
            mul = mul * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        if self.affine:
            y = y + self.bias[:, None, None]
        return y.to(x.dtype)


class ParamFreeBatchNorm(FlaxBatchNorm):
    """flax `nn.BatchNorm(use_scale=False, use_bias=False, momentum=0.9)`."""

    def __init__(self, features: int, eps: float = 1e-5, axis_name=None):
        super().__init__(features, eps=eps, affine=False, axis_name=axis_name)


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
        layers = [conv3x3(cin, features), InstanceNorm(), nn.ReLU(),
                  conv3x3(features, features)]
        if use_output_act:
            layers += [InstanceNorm(), nn.ReLU()]
        self.double_conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.double_conv(x)


class ResBlock(nn.Module):
    """DoubleConv + (1×1 conv, IN) identity, ReLU; returns (maxpooled, skip)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.downsample = nn.Sequential(Conv(cin, features, 1, bias=False), InstanceNorm())
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
        x = nearest_upsample(down_input)
        return self.double_conv(torch.cat([x, skip_input.to(x.dtype)], dim=1))


class StyledDenorm(nn.Module):
    """SPADE denormalization: parameter-free BatchNorm modulated by γ,β
    computed from the style tensor; `axis_name` syncs the BatchNorm."""

    def __init__(self, features: int, style_channels: int, axis_name=None):
        super().__init__()
        self.param_free_norm = ParamFreeBatchNorm(features, axis_name=axis_name)
        self.mlp_shared = nn.Sequential(conv3x3(style_channels, features), nn.ReLU())
        self.mlp_gamma = conv3x3(features, features)
        self.mlp_beta = conv3x3(features, features)

    def forward(self, x, style):
        normalized = self.param_free_norm(x)
        actv = self.mlp_shared(style.to(x.dtype))
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class StyledResUpBlock(nn.Module):
    """Upsample (nearest, or conv + PixelShuffle) then two styled conv-norms
    with a plain conv-IN-ReLU residual; the skip is the SPADE style.
    `axis_name` syncs both norms' BatchNorms."""

    def __init__(self, cin: int, features: int, style_channels: int,
                 use_output_act: bool = True, use_pixel_shuffle: bool = False,
                 axis_name=None):
        super().__init__()
        self.use_output_act = use_output_act
        if use_pixel_shuffle:
            self.up_sample = nn.Sequential(conv3x3(cin, cin * 4), nn.PixelShuffle(2))
        else:
            self.up_sample = None
        self.conv = nn.Sequential(conv3x3(cin, features), InstanceNorm(), nn.ReLU())
        self.conv1 = conv3x3(cin, features)
        self.norm1 = StyledDenorm(features, style_channels, axis_name)
        self.conv2 = conv3x3(features, features)
        self.norm2 = StyledDenorm(features, style_channels, axis_name)

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
            self.conv = Conv(cin, features, 1, bias=False)
        else:
            self.conv = Conv(cin, features, 3, padding=rate, dilation=rate, bias=False)

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
