"""Data parallelism over a `torch.distributed` process group: one rank a
card under `torchrun`, the JAX package's `lax.pmean`/`all_gather` as
all-reduces (see `mesh.py`)."""

from .mesh import (
    DATA_AXIS,
    all_gather_rows,
    barrier,
    destroy_distributed,
    initialize_distributed,
    is_active,
    pmean,
    pmean_differentiable,
    rank_device,
    replicate,
    shard_batch,
    world,
)
