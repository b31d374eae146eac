"""U-Net encoder producing a full-resolution feature map, + VQ head.

Counterpart of `medical_image_editing_tpu/models/unet_encoder.py`
(reference `src/networks/unet_encoder.py`): 4 ResBlock downs, a bottleneck
DoubleConv, 4 ups back to full resolution, then vector quantization.
`encode_quantize` returns ids+1, so that 0 can mean "background" in edited
label maps. Modules are NCHW; `encode_quantize` takes and returns NHWC like
the JAX function. `init_codebook_from_batch` (k-means) is training work and
is not ported yet.
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.vq import VQModule, VQState, vq_apply, vq_lookup
from .blocks import DoubleConv, ResBlock, StyledResUpBlock, UpBlock


class UNetEncoder(nn.Module):
    """Feature extractor: x (B,in,H,W) → features (B,filters[0],H,W).
    Keys `down_conv1_{1..4}`, `double_conv1`, `up_conv1_{4..1}`."""

    def __init__(self, in_channels: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 use_styled_up_block: bool = False):
        super().__init__()
        f = tuple(filters)
        self.filters = f
        self.use_styled_up_block = bool(use_styled_up_block)
        cin = in_channels
        for i in range(4):
            setattr(self, f"down_conv1_{i + 1}", ResBlock(cin, f[i]))
            cin = f[i]
        self.double_conv1 = DoubleConv(f[3], f[4])
        for i in reversed(range(4)):
            if self.use_styled_up_block:
                up = StyledResUpBlock(f[i + 1], f[i], f[i])
            else:
                up = UpBlock(f[i + 1] + f[i], f[i])
            setattr(self, f"up_conv1_{i + 1}", up)

    def forward(self, x):
        skips = []
        for i in range(4):
            x, skip = getattr(self, f"down_conv1_{i + 1}")(x)
            skips.append(skip)
        x = self.double_conv1(x)
        for i in reversed(range(4)):
            x = getattr(self, f"up_conv1_{i + 1}")(x, skips[i])
        return x


def encode_quantize(
    encoder: UNetEncoder,
    vq_state: VQState,
    x: torch.Tensor,
    *,
    momentum: float = 0.99,
    eps: float = 1e-5,
    train: bool = False,
    backend: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Encoder forward on x (B,H,W,in) → features → VQ →
    (quantized (B,H,W,C), commit, ids+1 (B,H,W), vq_state').

    `train=True` applies the VQ EMA update to the returned state. The
    encoder runs in the mode its caller set (the entry points set eval);
    batch-statistics training of the styled encoder is not ported yet, so
    `train=True` with it raises."""
    if train and encoder.use_styled_up_block:
        raise NotImplementedError(
            "training the styled encoder's BatchNorm is not ported yet")
    feats = encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    quantized, commit, ids, new_vq = vq_apply(
        vq_state, feats, momentum=momentum, eps=eps, train=train, backend=backend,
    )
    return quantized, commit, ids + 1, new_vq


def get_embed_from_ids(vq_state: VQState, ids) -> torch.Tensor:
    """Editing-path lookup: 0-based ids (B,H,W) → embedding (B,H,W,C).
    Callers mask the background and subtract the +1 offset first."""
    return vq_lookup(vq_state, ids)


class EncoderWithVQ(UNetEncoder):
    """UNetEncoder + codebook buffers (`vq.embed`, `vq.cluster_size`,
    `vq.embed_avg`) + VQ hyperparameters: the reference `UNetEncoder`'s
    module and state-dict surface."""

    def __init__(self, in_channels: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 dict_size: int = 512, momentum: float = 0.99, eps: float = 1e-5,
                 use_styled_up_block: bool = False, knn_backend: str = "xla"):
        super().__init__(in_channels, filters, use_styled_up_block)
        self.dict_size = dict_size
        self.emb_dim = self.filters[0]
        self.momentum = momentum
        self.eps = eps
        self.knn_backend = knn_backend
        self.vq = VQModule(dict_size, self.emb_dim)

    def encode(self, x: torch.Tensor, train: bool = False):
        """x (B,H,W,in) → (quantized, commit, ids+1, vq_state')."""
        return encode_quantize(
            self, self.vq.state(), x, momentum=self.momentum, eps=self.eps,
            train=train, backend=self.knn_backend,
        )
