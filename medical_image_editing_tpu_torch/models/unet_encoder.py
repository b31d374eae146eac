"""U-Net encoder producing a full-resolution feature map, + VQ head.

Counterpart of `medical_image_editing_tpu/models/unet_encoder.py`
(reference `src/networks/unet_encoder.py`): 4 ResBlock downs, a bottleneck
DoubleConv, 4 ups back to full resolution, then vector quantization.
`encode_quantize` returns ids+1, so that 0 can mean "background" in edited
label maps. Modules are NCHW; `encode_quantize` and
`init_codebook_from_batch` take and return NHWC like the JAX functions.

`dtype` is the compute dtype, as the JAX module's: parameters stay float32
and the input is cast to it (see `blocks.py`). The styled variant's
BatchNorm follows the module's train/eval mode. `axis_name`
(`parallel.DATA_AXIS`, as the JAX module's) syncs that BatchNorm and, in
`EncoderWithVQ`, the codebook's EMA statistics over the ranks; the k-means
init gathers every rank's features.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.kmeans import kmeans
from ..ops.vq import VQModule, VQState, vq_apply, vq_lookup
from ..parallel.mesh import all_gather_rows
from .blocks import DoubleConv, ResBlock, StyledResUpBlock, UpBlock, set_compute_dtype


class UNetEncoder(nn.Module):
    """Feature extractor: x (B,in,H,W) → features (B,filters[0],H,W).
    Keys `down_conv1_{1..4}`, `double_conv1`, `up_conv1_{4..1}`."""

    def __init__(self, in_channels: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 use_styled_up_block: bool = False, dtype=None, axis_name=None):
        super().__init__()
        f = tuple(filters)
        self.filters = f
        self.use_styled_up_block = bool(use_styled_up_block)
        self.compute_dtype = dtype
        self.axis_name = axis_name
        cin = in_channels
        for i in range(4):
            setattr(self, f"down_conv1_{i + 1}", ResBlock(cin, f[i]))
            cin = f[i]
        self.double_conv1 = DoubleConv(f[3], f[4])
        for i in reversed(range(4)):
            if self.use_styled_up_block:
                up = StyledResUpBlock(f[i + 1], f[i], f[i], axis_name=axis_name)
            else:
                up = UpBlock(f[i + 1] + f[i], f[i])
            setattr(self, f"up_conv1_{i + 1}", up)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        x = x.to(self.compute_dtype or x.dtype)
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
    axis_name=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Encoder forward on x (B,H,W,in) → features → VQ →
    (quantized (B,H,W,C), commit, ids+1 (B,H,W), vq_state').

    `train=True` applies the VQ EMA update to the returned state, its
    statistics averaged over the ranks with `axis_name`. The
    encoder runs in the mode its caller set: the serving entry points set
    eval, the training step sets train (the styled encoder's BatchNorm then
    uses batch statistics and moves its running stats)."""
    feats = encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    quantized, commit, ids, new_vq = vq_apply(
        vq_state, feats, momentum=momentum, eps=eps, train=train, backend=backend,
        axis_name=axis_name,
    )
    return quantized, commit, ids + 1, new_vq


def get_embed_from_ids(vq_state: VQState, ids) -> torch.Tensor:
    """Editing-path lookup: 0-based ids (B,H,W) → embedding (B,H,W,C).
    Callers mask the background and subtract the +1 offset first."""
    return vq_lookup(vq_state, ids)


def init_codebook_from_batch(
    feats: torch.Tensor,
    vq_state: VQState,
    *,
    num_iters: int = 50,
    init_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    axis_name=None,
) -> VQState:
    """k-means codebook init from first-batch encoder features (B,H,W,C).

    As the JAX function (reference `unet_encoder.py:66-91`): with
    `axis_name`, every rank's feature rows gathered in rank order; then
    Lloyd's algorithm from K distinct rows (`init_idx`, or drawn from
    `generator`, which must be the ranks' replicated stream so that every
    rank starts from the same rows), computed alike on every rank; then
    `embed = embed_avg = centers` and `cluster_size = 0`, so the EMA
    continues from the initialised codebook."""
    c = feats.shape[-1]
    k = vq_state.embed.shape[0]
    flat = feats.reshape(-1, c)
    if axis_name is not None:
        flat = all_gather_rows(flat)
    _, centers = kmeans(flat, k, num_iters=num_iters, init_idx=init_idx,
                        generator=generator)
    return VQState(embed=centers, cluster_size=torch.zeros_like(vq_state.cluster_size),
                   embed_avg=centers.clone())


class EncoderWithVQ(UNetEncoder):
    """UNetEncoder + codebook buffers (`vq.embed`, `vq.cluster_size`,
    `vq.embed_avg`) + VQ hyperparameters: the reference `UNetEncoder`'s
    module and state-dict surface."""

    def __init__(self, in_channels: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 dict_size: int = 512, momentum: float = 0.99, eps: float = 1e-5,
                 use_styled_up_block: bool = False, knn_backend: str = "xla",
                 dtype=None, axis_name=None):
        super().__init__(in_channels, filters, use_styled_up_block, dtype, axis_name)
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
            train=train, backend=self.knn_backend, axis_name=self.axis_name,
        )
