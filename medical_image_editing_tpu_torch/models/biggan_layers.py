"""BigGAN-style building blocks of the U-Net GAN discriminator, NCHW.

Counterpart of `medical_image_editing_tpu/models/biggan_layers.py`
(reference `src/networks/biggan/layers.py`, vendored from
ajbrock/BigGAN-PyTorch): spectral-normalized conv and linear layers
(`SNConv`, `SNDense`), the SA-GAN non-local `Attention` block, and the
`DBlock` / `GBlock2` residual blocks. Submodules and buffers carry the
reference's state-dict keys (`conv1`, `conv2`, `conv_sc`, `theta`, `phi`,
`g`, `o`, `gamma`; `u0` (1,O) and `sv0` (1,) beside each weight), so a
reference `discriminator.*` state dict loads with `strict=True`.

Spectral norm follows the JAX package's semantics, which are flax's
`nn.SpectralNorm`, not `torch.nn.utils.spectral_norm`:
  * one power-iteration step from the stored `u` on every forward, eval
    included; `u` and σ are stored only in training;
  * `_l2_normalize(x) = x · rsqrt(Σx² + 1e-12)`;
  * σ = v·W·uᵀ with u and v detached: the gradient flows through W only;
  * the weight is divided by σ unless σ is 0.
flax flattens a conv kernel (kh,kw,I,O) to (kh·kw·I, O); the (O, I·kh·kw)
view here is its transpose up to the order of the columns, which neither
u (1,O) nor σ sees, so a flax `u` carries over as it is. Each forward's
u and v are new tensors: the buffers are overwritten with a copy, so
several forwards through one module can feed one autograd graph.

The convolutions are plain `F.conv2d` (cuDNN): the JAX package builds them
from flax's own `nn.Conv`, which never reaches its packed-conv dispatch.
Initialisation follows the JAX modules: orthogonal weights, zero biases,
a random-normal `u`, σ = 1, γ = 0. `CCBN`, `GBlockCond` and `SNEmbed`
serve the generator and projection discrimination and are not ported yet
(ROADMAP item 21).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import nearest_upsample

SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor, eps: float = SN_EPS) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, eps: float = SN_EPS):
    """One power-iteration step of flax's `SpectralNorm` on `weight`
    (O, ...) from `u` (1,O): returns (weight / σ, u' (1,O), v (1,K), σ)."""
    w_mat = weight.reshape(weight.shape[0], -1)
    with torch.no_grad():
        w_det = w_mat.detach()
        v = _l2_normalize(u @ w_det, eps)
        u_new = _l2_normalize(v @ w_det.t(), eps)
    sigma = ((v @ w_mat.t()) @ u_new.t())[0, 0]
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u_new, v, sigma


class _SNLayer(nn.Module):
    """A weight (O, ...) with optional bias and the BigGAN spectral-norm
    buffers `u0` (1,O) and `sv0` (1,)."""

    def __init__(self, weight_shape, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(weight_shape))
        self.bias = nn.Parameter(torch.zeros(weight_shape[0])) if bias else None
        self.register_buffer("u0", torch.randn(1, weight_shape[0]))
        self.register_buffer("sv0", torch.ones(1))

    def normalized_weight(self) -> torch.Tensor:
        w, u, _, sigma = spectral_normalize(self.weight, self.u0)
        if self.training:
            with torch.no_grad():
                self.u0.copy_(u)
                self.sv0.copy_(sigma.detach().reshape(1))
        return w

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Orthogonal weight, zero bias, random-normal u, σ = 1."""
        nn.init.orthogonal_(self.weight, generator=generator)
        if self.bias is not None:
            self.bias.zero_()
        self.u0.copy_(torch.randn(self.u0.shape, generator=generator))
        self.sv0.fill_(1.0)


class SNConv(_SNLayer):
    """Spectral-normalized k×k conv, SAME padding, stride 1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__((out_channels, in_channels, kernel_size, kernel_size), bias)
        self.padding = kernel_size // 2

    def forward(self, x):
        return F.conv2d(x, self.normalized_weight(), self.bias, padding=self.padding)


class SNDense(_SNLayer):
    """Spectral-normalized linear layer, weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__((out_features, in_features), bias)

    def forward(self, x):
        return F.linear(x, self.normalized_weight(), self.bias)


class Attention(nn.Module):
    """SA-GAN non-local block on (B,C,H,W): θ C→C/8 at full resolution,
    φ C→C/8 and g C→C/2 each 2× max-pooled, softmax(θᵀφ) over the pooled
    positions, o C/2→C; out = γ·o + x with a learnable 0-d γ."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.theta = SNConv(c, c // 8, 1, bias=False)
        self.phi = SNConv(c, c // 8, 1, bias=False)
        self.g = SNConv(c, c // 2, 1, bias=False)
        self.o = SNConv(c // 2, c, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, c, h, w = x.shape
        theta = self.theta(x).reshape(b, c // 8, h * w)
        phi = F.max_pool2d(self.phi(x), 2).reshape(b, c // 8, h * w // 4)
        g = F.max_pool2d(self.g(x), 2).reshape(b, c // 2, h * w // 4)
        beta = torch.softmax(torch.bmm(theta.transpose(1, 2), phi), dim=-1)  # (B,HW,HW/4)
        o = torch.bmm(g, beta.transpose(1, 2)).reshape(b, c // 2, h, w)
        return self.gamma * self.o(o) + x

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.gamma.zero_()


class DBlock(nn.Module):
    """BigGAN discriminator residual block: [relu] → conv1 → relu → conv2
    [→ 2× avg-pool]; the shortcut is 1×1 `conv_sc` where the channels
    change or the block downsamples, pooled after it (preactivation) or
    before it."""

    def __init__(self, in_channels: int, out_channels: int, wide: bool = True,
                 preactivation: bool = False, downsample: bool = False):
        super().__init__()
        hidden = out_channels if wide else in_channels
        self.preactivation = preactivation
        self.downsample = downsample
        self.conv1 = SNConv(in_channels, hidden, 3)
        self.conv2 = SNConv(hidden, out_channels, 3)
        learnable_sc = in_channels != out_channels or downsample
        self.conv_sc = SNConv(in_channels, out_channels, 1) if learnable_sc else None

    def forward(self, x):
        h = F.relu(x) if self.preactivation else x
        h = self.conv2(F.relu(self.conv1(h)))
        if self.downsample:
            h = F.avg_pool2d(h, 2)
        sc = x
        if self.preactivation:
            if self.conv_sc is not None:
                sc = self.conv_sc(sc)
            if self.downsample:
                sc = F.avg_pool2d(sc, 2)
        else:
            if self.downsample:
                sc = F.avg_pool2d(sc, 2)
            if self.conv_sc is not None:
                sc = self.conv_sc(sc)
        return h + sc


class GBlock2(nn.Module):
    """Decoder-side residual block without BatchNorm: relu → [2× nearest
    up] → conv1 → relu → conv2, plus the (upsampled, 1×1 `conv_sc` where the
    channels change or the block upsamples) input when `skip_connection`."""

    def __init__(self, in_channels: int, out_channels: int, upsample: bool = False,
                 skip_connection: bool = True):
        super().__init__()
        self.upsample = upsample
        self.skip_connection = skip_connection
        self.conv1 = SNConv(in_channels, out_channels, 3)
        self.conv2 = SNConv(out_channels, out_channels, 3)
        learnable_sc = in_channels != out_channels or upsample
        self.conv_sc = SNConv(in_channels, out_channels, 1) if learnable_sc else None

    def forward(self, x):
        h = F.relu(x)
        if self.upsample:
            h = nearest_upsample(h)
            x = nearest_upsample(x)
        h = self.conv2(F.relu(self.conv1(h)))
        if self.conv_sc is not None:
            x = self.conv_sc(x)
        return h + x if self.skip_connection else h
