"""PyTorch modules, NCHW with OIHW weights, named with the reference's torch
state-dict keys so reference-format checkpoints load with `strict=True`."""

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
from .unet_decoder import UNetDecoder
from .unet_encoder import EncoderWithVQ, UNetEncoder
