"""EMA vector quantizer — plain PyTorch path.

Counterpart of `medical_image_editing_tpu/ops/vq.py` (reference
`src/networks/vq/vq_module.py`). Both backends of the JAX package's seam
share `quantize` and differ only in the assignment: `knn_backend`
"pallas"/"faiss" takes the fused CUDA kernel (`vq_fused.vq_assign_fused`),
"xla"/"torch" its plain PyTorch version (`vq_fused.vq_assign_fused_reference`).

Layout: `vq_apply` takes features NHWC (B,H,W,C) like the JAX function, and
returns raw 0-based ids (B,H,W) int32; the +1 offset is the encoder's.
"""

from typing import NamedTuple, Tuple

import torch
from torch import nn


class VQState(NamedTuple):
    """Codebook state: embed (K,C), cluster_size (K,), embed_avg (K,C).

    `embed_avg` is (K,C) here, as in the JAX package; the reference's
    state dict stores it (C,K) — `VQModule` keeps that layout.
    """

    embed: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor


class VQModule(nn.Module):
    """Codebook buffers under the reference's state-dict keys
    (`vq_module.py:154-157`): `embed` (K,C), `cluster_size` (K,),
    `embed_avg` (C,K)."""

    def __init__(self, dict_size: int, emb_dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(dict_size, emb_dim))
        self.register_buffer("cluster_size", torch.zeros(dict_size))
        self.register_buffer("embed_avg", torch.zeros(emb_dim, dict_size))

    def reset_parameters(self, generator: torch.Generator):
        """Random-normal codebook, as `vq_init` (`vq_module.py:153-157`)."""
        embed = torch.randn(self.embed.shape, generator=generator)
        with torch.no_grad():
            self.embed.copy_(embed)
            self.cluster_size.zero_()
            self.embed_avg.copy_(embed.t())

    def state(self) -> VQState:
        return VQState(self.embed, self.cluster_size, self.embed_avg.t())


def straight_through(quantized, x):
    """Forward `quantized`, backward identity to `x`."""
    return x + (quantized - x).detach()


def vq_scores(embed: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """(N,K) assignment scores 2·x·eᵀ − ‖e‖² in f32 (‖x‖² dropped)."""
    embed = embed.float()
    return 2.0 * (flat.float() @ embed.t()) - (embed * embed).sum(1)[None, :]


def vq_assign(embed: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """1-NN code assignment: flat (N,C), embed (K,C) → ids (N,) int32.
    `argmax` returns the first index on ties, as `jnp.argmax` does."""
    return vq_scores(embed, flat).argmax(1).to(torch.int32)


def vq_lookup(state: VQState, ids: torch.Tensor) -> torch.Tensor:
    """Codebook gather, ids (...,) → (..., C)."""
    return state.embed[ids.long()]


def _ema(base, update, momentum):
    """base·m + update·(1−m)."""
    return base * momentum + update * (1.0 - momentum)


def quantize(state: VQState, x: torch.Tensor, assign, *, momentum: float,
             eps: float, train: bool):
    """Shared body of `vq_apply` and `vq_apply_fused`. `assign(embed, flat)`
    → (ids (N,), quantized rows (N,C), counts (K,), sums (K,C))."""
    k, c = state.embed.shape
    b, h, w, cc = x.shape
    if cc != c:
        raise ValueError(f"feature width {cc} != codebook width {c}")

    flat = x.detach().reshape(-1, c).float()
    ids_flat, quant_flat, counts, sums = assign(state.embed, flat)
    ids = ids_flat.reshape(b, h, w)
    quantized = quant_flat.reshape(b, h, w, c).to(x.dtype)

    commit_loss = torch.mean((x.float() - quantized.float()) ** 2)
    quantized_st = straight_through(quantized, x)
    if not train:
        return quantized_st, commit_loss, ids, state

    # EMA of counts/sums, Laplace-smoothed normalization (`vq_module.py:182-200`)
    cluster_size = _ema(state.cluster_size, counts, momentum)
    embed_avg = _ema(state.embed_avg, sums, momentum)
    n = cluster_size.sum()
    smoothed = n * (cluster_size + eps) / (n + k * eps)
    new_state = VQState(embed=embed_avg / smoothed[:, None],
                        cluster_size=cluster_size, embed_avg=embed_avg)
    return quantized_st, commit_loss, ids, new_state


def vq_apply(
    state: VQState,
    x: torch.Tensor,
    *,
    momentum: float = 0.99,
    eps: float = 1e-5,
    train: bool = True,
    backend: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Quantize x (B,H,W,C) → (quantized_st, commit_loss, ids (B,H,W), state').

    `backend` "pallas"/"faiss" runs the fused CUDA kernel on CUDA tensors,
    "xla"/"torch" its plain PyTorch version. With `train=True` the EMA
    codebook update is applied to the returned state (the input state is not
    modified).
    """
    from .vq_fused import vq_assign_fused, vq_assign_fused_reference

    if backend in ("pallas", "faiss"):
        assign = vq_assign_fused
    elif backend in ("xla", "torch"):
        assign = vq_assign_fused_reference
    else:
        raise ValueError(f"unknown knn_backend {backend!r}")
    return quantize(state, x, assign, momentum=momentum, eps=eps, train=train)
