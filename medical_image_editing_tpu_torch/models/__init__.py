"""PyTorch modules, NCHW with OIHW weights, named with the reference's torch
state-dict keys so reference-format checkpoints load with `strict=True`; the
volumetric VQ-WNet (`volumetric.py`, no reference counterpart) is NCDHW and
named by the JAX package's flax variable paths; minGPT (`mingpt.py`) takes
(B, T) token ids."""

from .actnorm import ActNorm
from .biggan_layers import Attention, DBlock, GBlock2, SNConv, SNDense
from .blocks import (
    ASPP,
    DoubleConv,
    ResBlock,
    StyledDenorm,
    StyledResUpBlock,
    UpBlock,
    instance_norm,
    pixel_shuffle,
)
from .discriminator import NLayerDiscriminator
from .mingpt import GPT, Block, CausalSelfAttention, GPTConfig
from .unet_decoder import UNetDecoder
from .unet_discriminator import UNetDiscriminator, d_unet_arch
from .unet_encoder import EncoderWithVQ, UNetEncoder
from .volumetric import VolumetricUNetDecoder, VolumetricUNetEncoder
from .vqgan import VQGAN
