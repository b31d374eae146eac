"""VQGAN autoencoder (taming-transformers style), NCHW.

Counterpart of `medical_image_editing_tpu/models/vqgan.py` (reference
`src/networks/vqgan.py`): swish + GroupNorm(32, eps 1e-6) (`gcd(C, 32)`
groups for widths not divisible by 32; on the CPU its statistics in two
passes, see `GroupNorm`), `ResnetBlock` with dropout and a
1×1 (`nin_shortcut`) or 3×3 (`conv_shortcut`) shortcut on a channel change,
single-head spatial `AttnBlock` (scores a plain f32 `matmul` scaled by
1/√C, then `softmax`), `Downsample` (stride 2 after an asymmetric (0, 1)
pad), `Upsample` (2× nearest, then a conv), the encoder with its
ch-multiplier schedule and mid attention, the mirrored decoder, and
`VQGAN` = encoder → VQ → decoder returning (recon, commit, ids, emb).

Submodules carry the reference's state-dict keys (`encoder.conv_in`,
`encoder.down.{l}.block.{b}`, `encoder.down.{l}.attn.{b}`,
`encoder.down.{l}.downsample.conv`, `encoder.mid.block_1`, ...,
`decoder.up.{l}.upsample.conv`, `vq.embed`), the names the JAX package's
`utils/torch_import.py::import_vqgan` reads, so a reference checkpoint's
`decoder.` field loads with `strict=True`.

The convolutions are plain `nn.Conv2d` (cuDNN): the JAX module builds them
with flax's `nn.Conv`, which never reaches the packed-conv dispatch. The
codebook is `ops/vq.py::VQModule`; with `knn_backend` "pallas"/"faiss" the
assignment runs the fused CUDA kernel on CUDA tensors. The ids are raw and
0-based at the bottleneck resolution: unlike `EncoderWithVQ`, the VQGAN
adds no +1. The JAX module keeps the codebook outside (`VQState`) and
returns the EMA-updated state; here a train-mode forward writes it into
the module's buffers. Dropout (`p_dropout` > 0) draws its masks from the
`generator` passed to `forward`. With `axis_name` (`parallel.DATA_AXIS`,
as the JAX module's) a train-mode forward averages the codebook's counts
and sums over the ranks before the EMA (`ops/vq.py`).
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vq import VQModule, vq_apply, vq_lookup


def swish(x):
    return F.silu(x)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` whose statistics on a CPU tensor are taken in two
    passes (the mean, then the mean squared deviation). ATen's CPU kernel
    for channels-last input, which oneDNN's CPU convolutions return, loses
    precision where a group's |mean| is many times its std: 1.6e-4
    (relative) after the first convolution of a smooth slice; its CUDA
    kernel (Welford) and the two passes agree with float64 to rounding.
    CUDA tensors take `F.group_norm`."""

    def forward(self, x):
        if x.device.type != "cpu":
            return super().forward(x)
        xg = x.reshape(x.shape[0], self.num_groups, -1)
        mean = xg.mean(-1, keepdim=True)
        centered = xg - mean
        var = centered.pow(2).mean(-1, keepdim=True)
        y = (centered * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def group_norm(channels: int) -> GroupNorm:
    """GroupNorm(32, eps 1e-6); `gcd(C, 32)` groups for other widths."""
    groups = 32 if channels % 32 == 0 else math.gcd(channels, 32)
    return GroupNorm(groups, channels, eps=1e-6)


def conv(cin: int, cout: int, k: int = 3, stride: int = 1, padding: Optional[int] = None):
    return nn.Conv2d(cin, cout, k, stride, k // 2 if padding is None else padding)


def dropout(x, p: float, generator: Optional[torch.Generator]):
    """flax's `nn.Dropout(p)` in training: keep with probability 1 − p and
    scale by 1/(1 − p); the mask drawn from `generator`."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ResnetBlock(nn.Module):
    """GN-swish-conv ×2 with dropout, and a shortcut conv on a channel
    change. Keys `norm1`, `conv1`, `norm2`, `conv2`, `nin_shortcut` (1×1)
    or `conv_shortcut` (3×3)."""

    def __init__(self, cin: int, cout: int, use_conv_shortcut: bool = False,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.norm1 = group_norm(cin)
        self.conv1 = conv(cin, cout)
        self.norm2 = group_norm(cout)
        self.conv2 = conv(cout, cout)
        if cin != cout:
            if use_conv_shortcut:
                self.conv_shortcut = conv(cin, cout, 3)
            else:
                self.nin_shortcut = conv(cin, cout, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.conv1(swish(self.norm1(x)))
        h = swish(self.norm2(h))
        if self.p_dropout > 0 and self.training:
            h = dropout(h, self.p_dropout, generator)
        h = self.conv2(h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention, scores scaled by 1/√C. Keys
    `norm`, `q`, `k`, `v`, `proj_out`."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = group_norm(channels)
        self.q = conv(channels, channels, 1)
        self.k = conv(channels, channels, 1)
        self.v = conv(channels, channels, 1)
        self.proj_out = conv(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)  # (b, hw, c)
        k = self.k(hn).reshape(b, c, h * w)                  # (b, c, hw)
        v = self.v(hn).reshape(b, c, h * w)
        attn = torch.softmax(torch.matmul(q, k) * (c ** -0.5), dim=-1)  # (b, q, k)
        out = torch.matmul(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 3×3 conv after a (0, 1) pad of bottom and right, or a 2×2
    average pool. Key `conv`."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = conv(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class Upsample(nn.Module):
    """2× nearest, then (with `with_conv`) a 3×3 conv. Key `conv`."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = conv(channels, channels)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


class _Level(nn.Module):
    """One resolution of the encoder (`block`, `attn`, `downsample`) or the
    decoder (`block`, `attn`, `upsample`)."""

    def __init__(self, blocks, attns, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample is not None:
            setattr(self, resample_name, resample)

    def forward(self, h, generator=None):
        for i, block in enumerate(self.block):
            h = block(h, generator)
            if len(self.attn):
                h = self.attn[i](h)
        return h


class _Mid(nn.Module):
    def __init__(self, channels: int, p_dropout: float):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, p_dropout=p_dropout)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels, p_dropout=p_dropout)

    def forward(self, h, generator=None):
        return self.block_2(self.attn_1(self.block_1(h, generator)), generator)


class VQGANEncoder(nn.Module):
    """x (B,in,H,W) → z (B,out,H/2^(L−1),W/2^(L−1))."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 ch_multiplier: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int, p_dropout: float = 0.0,
                 resamp_with_conv: bool = True):
        super().__init__()
        self.conv_in = conv(in_channels, mid_channels)
        levels, cin, res = [], mid_channels, resolution
        n_levels = len(ch_multiplier)
        for i in range(n_levels):
            cout = mid_channels * ch_multiplier[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, cout, p_dropout=p_dropout))
                cin = cout
                if res in attn_resolutions:
                    attns.append(AttnBlock(cin))
            down = Downsample(cin, resamp_with_conv) if i != n_levels - 1 else None
            levels.append(_Level(blocks, attns, "downsample", down))
            if down is not None:
                res //= 2
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(cin, p_dropout)
        self.norm_out = group_norm(cin)
        self.conv_out = conv(cin, out_channels)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.conv_in(x)
        for level in self.down:
            h = level(h, generator)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h, generator)
        return self.conv_out(swish(self.norm_out(h)))


class VQGANDecoder(nn.Module):
    """z (B,in,h,w) → image (B,out,h·2^(L−1),w·2^(L−1)); `up.{l}` is level
    l, walked from the last to the first."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 ch_multiplier: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int, p_dropout: float = 0.0,
                 resamp_with_conv: bool = True):
        super().__init__()
        n_levels = len(ch_multiplier)
        cin = mid_channels * ch_multiplier[-1]
        res = resolution // 2 ** (n_levels - 1)
        self.conv_in = conv(in_channels, cin)
        self.mid = _Mid(cin, p_dropout)
        levels = [None] * n_levels
        for i in reversed(range(n_levels)):
            cout = mid_channels * ch_multiplier[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, cout, p_dropout=p_dropout))
                cin = cout
                if res in attn_resolutions:
                    attns.append(AttnBlock(cin))
            up = Upsample(cin, resamp_with_conv) if i != 0 else None
            levels[i] = _Level(blocks, attns, "upsample", up)
            if up is not None:
                res *= 2
        self.up = nn.ModuleList(levels)
        self.norm_out = group_norm(cin)
        self.conv_out = conv(cin, out_channels)

    def forward(self, z, generator: Optional[torch.Generator] = None):
        h = self.mid(self.conv_in(z), generator)
        for level in reversed(self.up):
            h = level(h, generator)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class VQGAN(nn.Module):
    """The constructor surface of the JAX `VQGAN` (`vq_momentum` is the EMA
    momentum: the JAX trainer leaves it at 0.99). forward(x (B,in,H,W),
    train) → (recon (B,out,H,W), commit, ids (B,h,w) int32 0-based, emb
    (B,emb_dim,h,w)); in train mode the codebook's EMA moves."""

    def __init__(self, in_channels: int = 1, mid_channels: int = 32, out_channels: int = 1,
                 emb_dim: int = 512, dict_size: int = 64,
                 enc_ch_multiplier: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 dec_ch_multiplier: Sequence[int] = (1, 1, 2, 4, 8, 16),
                 num_res_blocks: int = 2, enc_attn_resolutions: Sequence[int] = (),
                 dec_attn_resolutions: Sequence[int] = (16,), resolution: int = 512,
                 p_dropout: float = 0.0, resamp_with_conv: bool = True,
                 vq_momentum: float = 0.99, vq_eps: float = 1e-5, knn_backend: str = "xla",
                 axis_name=None):
        super().__init__()
        self.emb_dim, self.dict_size, self.p_dropout = emb_dim, dict_size, p_dropout
        self.momentum, self.eps, self.knn_backend = vq_momentum, vq_eps, knn_backend
        self.axis_name = axis_name
        common = dict(mid_channels=mid_channels, num_res_blocks=num_res_blocks,
                      resolution=resolution, p_dropout=p_dropout,
                      resamp_with_conv=resamp_with_conv)
        self.encoder = VQGANEncoder(in_channels, out_channels=emb_dim,
                                    ch_multiplier=tuple(enc_ch_multiplier),
                                    attn_resolutions=tuple(enc_attn_resolutions), **common)
        self.decoder = VQGANDecoder(emb_dim, out_channels=out_channels,
                                    ch_multiplier=tuple(dec_ch_multiplier),
                                    attn_resolutions=tuple(dec_attn_resolutions), **common)
        self.vq = VQModule(dict_size, emb_dim)

    def forward(self, x, train: bool = True, generator: Optional[torch.Generator] = None):
        z = self.encoder(x, generator).permute(0, 2, 3, 1)
        emb, commit, ids, new_vq = vq_apply(self.vq.state(), z, momentum=self.momentum,
                                            eps=self.eps, train=train,
                                            backend=self.knn_backend, axis_name=self.axis_name)
        if train:
            self.vq.set_state(new_vq)
        emb = emb.permute(0, 3, 1, 2)
        return self.decoder(emb, generator), commit, ids, emb

    def generate_image_from_ids(self, ids):
        """Decode a painted bottleneck id map (B,h,w), 0-based."""
        emb = vq_lookup(self.vq.state(), ids).permute(0, 3, 1, 2)
        return self.decoder(emb)
