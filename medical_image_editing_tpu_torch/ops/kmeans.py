"""Lloyd k-means for the codebook initialisation.

Counterpart of `medical_image_editing_tpu/ops/kmeans.py` (reference: the
first-batch `kmeans_pytorch.kmeans` of `src/networks/unet_encoder.py:66-91`).
The initial centres are K distinct rows of x, given as `init_idx` or drawn
from `generator`; the JAX function draws them with
`jax.random.choice(key, n, (k,), replace=False)`, which the tests replay.
Each iteration assigns by argmax of 2·x·cᵀ − ‖c‖² (first index on ties)
and moves every non-empty cluster to its mean; an empty one keeps its centre.
"""

from typing import Optional, Tuple

import torch


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    scores = 2.0 * (x @ centers.t()) - (centers * centers).sum(1)[None, :]
    return scores.argmax(1)


def kmeans(
    x: torch.Tensor,
    num_clusters: int,
    num_iters: int = 50,
    *,
    init_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, C) → (ids (N,) int32, centers (K, C) f32)."""
    x = x.detach().float()
    n = x.shape[0]
    if init_idx is None:
        dev = x.device if generator is None else generator.device
        init_idx = torch.randperm(n, generator=generator, device=dev)[:num_clusters]
    centers = x[torch.as_tensor(init_idx, device=x.device).long()]
    k = torch.arange(num_clusters, device=x.device)
    for _ in range(num_iters):
        onehot = (_assign(x, centers)[:, None] == k[None, :]).float()
        counts = onehot.sum(0)
        sums = onehot.t() @ x
        centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None], centers)
    return _assign(x, centers).to(torch.int32), centers
