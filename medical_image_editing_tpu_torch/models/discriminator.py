"""Pix2Pix-style PatchGAN discriminator, NCHW.

Counterpart of `medical_image_editing_tpu/models/discriminator.py`
(reference `src/networks/discriminator.py`, `NLayerDiscriminator` from
taming-transformers): 4×4 convs (stride 2 for the first `n_layers`, then
stride 1), LeakyReLU(0.2), channel multipliers min(2ⁿ, 8), instance,
batch or act normalization (bias-free convs under batchnorm), a final 4×4
conv to a 1-channel logit map. Optional spectral norm on every conv, with the JAX package's (flax's)
semantics (`biggan_layers.spectral_normalize`).

Keys are the reference's: one `main` Sequential, conv j at `main.{0 if j
== 0 else 3j − 1}`, norm k at `main.{3k + 3}`. A spectral-normalized conv
carries `torch.nn.utils.spectral_norm`'s names (`weight_orig`, `weight_u`
(O,), `weight_v`), as the reference applies it, so
`import_nlayer_discriminator` reads the same keys; `weight_v` is stored
for those keys only and never read. The batchnorm is flax's
(`blocks.FlaxBatchNorm`: batch statistics in training, the biased
variance in the running stats); the actnorm is `models/actnorm.py`
(initialised on the first train-mode forward). With `axis_name`
(`parallel.DATA_AXIS`) both take their statistics over the ranks, as the
JAX module passes its `axis_name` to `nn.BatchNorm` and `ActNorm`.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .actnorm import ActNorm
from .biggan_layers import spectral_normalize
from .blocks import FlaxBatchNorm, InstanceNorm


class SNConv2d(nn.Module):
    """A conv under `torch.nn.utils.spectral_norm`'s keys with flax's
    spectral-norm forward (one power step every call; u and v stored in
    training)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int, bias: bool):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(
            torch.zeros(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer("weight_u", torch.randn(out_channels))
        self.register_buffer("weight_v", torch.zeros(in_channels * kernel_size**2))

    def forward(self, x):
        w, u, v, _ = spectral_normalize(self.weight_orig, self.weight_u[None])
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u[0])
                self.weight_v.copy_(v[0])
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class NLayerDiscriminator(nn.Module):
    """x (B,in,H,W) → logits (B,out,H/2^n_layers − 2,W/2^n_layers − 2)."""

    def __init__(self, out_channels: int = 1, n_filters: int = 64, n_layers: int = 3,
                 normalization: str = "batchnorm", apply_spectral_norm: bool = False,
                 in_channels: int = 1, axis_name=None):
        super().__init__()
        if normalization not in ("instancenorm", "batchnorm", "actnorm"):
            raise ValueError(f"unknown normalization {normalization!r}")
        use_bias = normalization != "batchnorm"

        def conv(cin, cout, stride, bias=True):
            if apply_spectral_norm:
                return SNConv2d(cin, cout, 4, stride, 1, bias)
            return nn.Conv2d(cin, cout, 4, stride, 1, bias=bias)

        def norm(c):
            if normalization == "batchnorm":
                return FlaxBatchNorm(c, axis_name=axis_name)
            return (ActNorm(c, axis_name=axis_name) if normalization == "actnorm"
                    else InstanceNorm())

        layers = [conv(in_channels, n_filters, 2), nn.LeakyReLU(0.2)]
        cin = n_filters
        for n in range(1, n_layers):
            cout = n_filters * min(2**n, 8)
            layers += [conv(cin, cout, 2, use_bias), norm(cout), nn.LeakyReLU(0.2)]
            cin = cout
        cout = n_filters * min(2**n_layers, 8)
        layers += [conv(cin, cout, 1, use_bias), norm(cout), nn.LeakyReLU(0.2),
                   conv(cout, out_channels, 1)]
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "NLayerDiscriminator":
        """The JAX module's initialisation, drawn from `generator` in module
        order: conv weights N(0, 0.02), zero biases, BatchNorm scale 1 and
        bias 0 with reset running stats, ActNorm at loc 0 and scale 1 (not
        initialized), a random-normal spectral-norm u."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, SNConv2d)):
                w = m.weight if isinstance(m, nn.Conv2d) else m.weight_orig
                w.copy_(torch.randn(w.shape, generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
                if isinstance(m, SNConv2d):
                    m.weight_u.copy_(torch.randn(m.weight_u.shape, generator=generator))
                    m.weight_v.zero_()
            elif isinstance(m, (FlaxBatchNorm, ActNorm)):
                m.reset_parameters()
        return self
