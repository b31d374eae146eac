"""BigGAN-based U-Net GAN discriminator, NCHW.

Counterpart of `medical_image_editing_tpu/models/unet_discriminator.py`
(reference `src/networks/unet_discriminator.py`, from boschresearch/
unetgan): the `d_unet_arch` channel tables for 128/256/512, a down path of
`DBlock`s and an up path of `GBlock2`s with skip concatenations, and three
outputs:
  * the per-pixel decision map (B,1,H,W) from a 1×1 conv,
  * the global bottleneck logit (B,output_dim): sum-pooled ReLU features
    through the spectral-normalized `linear_middle`,
  * the list of the up path's features, for the "unet_perceptual"
    feature-matching loss.
Attention sits only on down-path blocks whose resolution is in `D_attn`
(index < 5), as in the reference.

The module tree is the reference's key space: `blocks.{i}.0` is block i
(`conv1`, `conv2`, `conv_sc`), `blocks.{i}.1` its attention (`theta`,
`phi`, `g`, `o`, `gamma`), `blocks.{n}` the final 1×1 conv, and
`linear_middle`. The reference also builds a `linear` layer that its
forward never uses: drop its `linear.*` keys (`reference_state_dict`)
and a reference `discriminator.*` state dict loads with `strict=True`.

Unconditional only (the trainers' usage). Projection discrimination
(`n_classes > 0`, `SNEmbed`) is not ported yet (ROADMAP item 21).
"""

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .biggan_layers import Attention, DBlock, GBlock2, SNDense


def d_unet_arch(resolution: int, ch: int):
    """Channel schedule per resolution (reference `unet_discriminator.py:350-383`)."""
    if resolution == 128:
        out_mult = [1, 2, 4, 8, 16, 8, 4, 2, 1, 1]
        down = [True] * 5 + [False] * 5
        res = [64, 32, 16, 8, 4, 8, 16, 32, 64, 128]
        skip_at = {6: 4, 7: 3, 8: 2, 9: 1}
    elif resolution == 256:
        out_mult = [1, 2, 4, 8, 8, 16, 8, 8, 4, 2, 1, 1]
        down = [True] * 6 + [False] * 6
        res = [128, 64, 32, 16, 8, 4, 8, 16, 32, 64, 128, 256]
        skip_at = {7: 5, 8: 4, 9: 3, 10: 2, 11: 1}
    elif resolution == 512:
        out_mult = [1, 2, 4, 8, 8, 8, 16, 8, 8, 8, 4, 2, 1, 1]
        down = [True] * 7 + [False] * 7
        res = [256, 128, 64, 32, 16, 8, 4, 8, 16, 32, 64, 128, 256, 512]
        skip_at = {8: 6, 9: 5, 10: 4, 11: 3, 12: 2, 13: 1}
    else:
        raise ValueError(f"unsupported resolution {resolution}")
    return {
        "out_channels": [m * ch for m in out_mult],
        "downsample": down,
        "upsample": [not d for d in down],
        "resolution": res,
        "skip_at": skip_at,
    }


def attention_resolutions(d_attn) -> set:
    """`D_attn` "64" / "32_64" / "0" → the set of resolutions given attention."""
    return {int(s) for s in str(d_attn).split("_") if s.isdigit()}


class UNetDiscriminator(nn.Module):
    """x (B,in,res,res) → (pixel map (B,1,res,res), bottleneck (B,output_dim),
    up-path features). Constructor surface of the JAX module (`D_ch`,
    `D_wide`, `D_attn`, `resolution`, `output_dim`, `n_classes`) plus the
    input channels, which torch needs up front."""

    def __init__(self, D_ch: int = 64, D_wide: bool = True, D_attn: str = "64",
                 resolution: int = 512, output_dim: int = 1, n_classes: int = 0,
                 in_channels: int = 1):
        super().__init__()
        if n_classes > 0:
            raise NotImplementedError(
                "the conditional UNetDiscriminator (n_classes > 0, projection "
                "discrimination with SNEmbed) is not ported to the PyTorch package "
                "yet (ROADMAP item 21); use the JAX package for it")
        self.D_ch, self.D_wide, self.D_attn = int(D_ch), bool(D_wide), str(D_attn)
        self.resolution, self.output_dim = int(resolution), int(output_dim)
        arch = d_unet_arch(self.resolution, self.D_ch)
        self.arch = arch
        attn_res = attention_resolutions(D_attn)
        out = arch["out_channels"]
        self.n_down = sum(arch["downsample"])
        # channels of x and of every down block's output kept for the skips
        residual_ch = [in_channels] + out[: self.n_down - 1]
        self.has_attention = []
        blocks = []
        ch = in_channels
        for index, cout in enumerate(out):
            if index in arch["skip_at"]:
                ch += residual_ch[arch["skip_at"][index]]
            if arch["downsample"][index]:
                block = DBlock(ch, cout, wide=self.D_wide, preactivation=index > 0,
                               downsample=True)
            else:
                block = GBlock2(ch, cout, upsample=True, skip_connection=True)
            entry = [block]
            attn = arch["resolution"][index] in attn_res and index < 5
            if attn:
                entry.append(Attention(cout))
            self.has_attention.append(attn)
            blocks.append(nn.ModuleList(entry))
            ch = cout
        blocks.append(nn.Conv2d(ch, 1, 1))
        self.blocks = nn.ModuleList(blocks)
        self.linear_middle = SNDense(out[self.n_down - 1], self.output_dim)

    def forward(self, x):
        arch = self.arch
        residual_features = [x]
        features_out = []
        bottleneck = None
        h = x
        for index in range(len(arch["out_channels"])):
            if index in arch["skip_at"]:
                h = torch.cat([h, residual_features[arch["skip_at"][index]]], dim=1)
            entry = self.blocks[index]
            h = entry[0](h)
            if not arch["downsample"][index]:
                features_out.append(h)
            if self.has_attention[index]:
                h = entry[1](h)
                if not arch["downsample"][index]:
                    features_out[-1] = h
            if arch["downsample"][index] and index < self.n_down - 1:
                residual_features.append(h)
            if index == self.n_down - 1:
                bottleneck = self.linear_middle(F.relu(h).sum((2, 3)))
        return self.blocks[-1](h), bottleneck, features_out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UNetDiscriminator":
        """The JAX module's initialisation, drawn from `generator` in module
        order: orthogonal weights, zero biases, random-normal `u0`, σ = 1,
        γ = 0."""
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self and not isinstance(
                    m, nn.Conv2d):
                m.reset_parameters(generator)
        final = self.blocks[-1]
        nn.init.orthogonal_(final.weight, generator=generator)
        final.bias.zero_()
        return self


def reference_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference `Unet_Discriminator` state dict without the `linear.*`
    layer its forward never uses: what `UNetDiscriminator` loads with
    `strict=True`."""
    return {k: v for k, v in sd.items() if not k.startswith("linear.")}
