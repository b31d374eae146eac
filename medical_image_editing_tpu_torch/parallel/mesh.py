"""Data parallelism over a `torch.distributed` process group.

Counterpart of `medical_image_editing_tpu/parallel/mesh.py` (reference: the
Lightning DDP over NCCL of `run_vqwnet.py:112-127`). The JAX package writes
one per-device step with collectives over the mesh axis `DATA_AXIS` and maps
it over a 1-D device mesh; here each rank is one process (one card under
`torchrun`) running the same step on its own rows, and the collectives run
over the default process group:

| JAX (`axis_name=DATA_AXIS`)                 | here                                   |
|---------------------------------------------|----------------------------------------|
| `lax.pmean(grads)` in the step              | `pmean(grads)`: one flattened all-reduce |
| `lax.pmean` of the VQ counts and sums        | `pmean([counts, sums])` in `ops/vq.py` |
| `nn.BatchNorm(axis_name=...)`               | `pmean_differentiable` in `FlaxBatchNorm` |
| `lax.all_gather` before the k-means          | `all_gather_rows`                      |
| `replicate(mesh, state)`                    | `replicate`: broadcast from rank 0 and a check |
| `shard_batch(mesh, batch)`                  | `shard_batch`: this rank's row block   |
| `jax.distributed.initialize`                | `initialize_distributed` (torchrun's environment) |

As in JAX, a module or step built with `axis_name=DATA_AXIS` averages over
the ranks and one built with None stays local. With no process group the
collectives are the identity (one rank), so a step built for the group runs
unchanged, bit for bit, without one.

`collectives` counts the all-reduces and broadcasts issued and the bytes
they carried, as `ops._build.launches` counts kernel launches.
"""

import collections
import os
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"

collectives: collections.Counter = collections.Counter()


def is_active() -> bool:
    """Whether a default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, else (0, 1)."""
    if is_active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(device="cuda") -> bool:
    """Create the default process group from `torchrun`'s environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`):
    NCCL for a CUDA `device`, after `torch.cuda.set_device(LOCAL_RANK)`;
    gloo for the CPU. Without `WORLD_SIZE` it does nothing; `WORLD_SIZE=1`
    makes a one-rank group. A failed init raises: no other backend is
    tried. A group that already exists (a caller that made its own) is
    used as it is. Returns True when this call created the group, which the
    caller then ends with `destroy_distributed`."""
    if "WORLD_SIZE" not in os.environ:
        return False
    size = int(os.environ["WORLD_SIZE"])
    if is_active():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists "
                               f"where WORLD_SIZE is {size}")
        return False
    rank = int(os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size)
    return True


def destroy_distributed() -> None:
    """Destroy the default process group, if there is one."""
    if is_active():
        dist.destroy_process_group()


def rank_device(device="cuda") -> torch.device:
    """The device a rank computes on: `device` as `resolve_device` gives it,
    and under a process group an unindexed "cuda" as the current card
    (`cuda:LOCAL_RANK` after `initialize_distributed`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and is_active():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if not is_active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
    collectives["all_reduce"] += 1
    collectives["all_reduce_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op)


def _flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    kinds = {(t.dtype, t.device) for t in tensors}
    if len(kinds) != 1:
        raise ValueError("pmean over tensors of several dtypes or devices: "
                         f"{sorted(map(str, kinds))}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def pmean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`lax.pmean` over the ranks: each tensor's mean over the ranks, from
    one all-reduce (sum) of their concatenation divided by the world size.
    The results are views of one new buffer; the inputs are not changed.
    All tensors share one dtype and device. Without a group (or with no
    tensors) the tensors come back as given. Outside autograd: see
    `pmean_differentiable`."""
    tensors = list(tensors)
    if not is_active() or not tensors:
        return tensors
    flat = _flatten([t.detach() for t in tensors])
    _all_reduce(flat)
    flat.div_(dist.get_world_size())
    return _split(flat, tensors)


class _AllReduceMean(torch.autograd.Function):
    """Mean over the ranks, forward and backward: the cotangent of a pmean
    is the pmean of the ranks' cotangents (`lax.pmean`'s transpose in the
    JAX package's `shard_map`), so each rank's gradient takes in the other
    ranks' losses through the shared statistics."""

    @staticmethod
    def forward(ctx, flat):
        out = flat.clone()
        _all_reduce(out)
        return out.div_(dist.get_world_size())

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        _all_reduce(grad)
        return grad.div_(dist.get_world_size())


def pmean_differentiable(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`pmean` inside autograd: one all-reduce forward and one backward (a
    synced batch norm's mean and mean of squares). Without a group, the
    tensors as given."""
    tensors = list(tensors)
    if not is_active() or not tensors:
        return tensors
    return _split(_AllReduceMean.apply(_flatten(tensors)), tensors)


def _check_same(values: Sequence[int], device, what: str) -> None:
    """Raise RuntimeError unless every rank holds the same `values` (one
    all-reduce of (v, −v) under MAX)."""
    v = torch.tensor([int(x) for x in values], dtype=torch.int64, device=device)
    both = torch.cat([v, -v])
    _all_reduce(both, dist.ReduceOp.MAX)
    hi, lo = both[: len(v)], -both[len(v):]
    if not torch.equal(hi, lo):
        raise RuntimeError(f"ranks disagree on {what}: max {hi.tolist()}, min {lo.tolist()}")


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """`lax.all_gather(x, DATA_AXIS)` flattened over the ranks: every
    rank's `x` (one shape on all ranks, checked) concatenated along the
    leading axis in rank order. One all-reduce (sum) of a zero buffer that
    holds each rank's rows in its own slot: exact, since x + 0 = x, and
    gloo reduces CUDA tensors where it gathers none. Without a group, `x`."""
    if not is_active():
        return x
    rank, size = world()
    _check_same(x.shape, x.device, "the shape of the gathered rows")
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[rank] = x
    _all_reduce(buf)
    return buf.reshape((size * x.shape[0],) + tuple(x.shape[1:]))


def replicate(tensors: Iterable[torch.Tensor], fingerprint: Sequence[int] = (),
              device=None) -> None:
    """Make every rank hold rank 0's tensors (broadcast in place), then
    check that `fingerprint` — host-side values the ranks must already
    share, such as step counters and a digest of a generator's state — is
    the same on every rank (RuntimeError where it is not). Nothing without
    a group."""
    if not is_active():
        return
    tensors = list(tensors)
    with torch.no_grad():  # parameters are written in place
        for t in tensors:
            collectives["broadcast"] += 1
            collectives["broadcast_bytes"] += t.numel() * t.element_size()
            dist.broadcast(t, src=0)
    if device is None:
        device = tensors[0].device if tensors else "cpu"
    _check_same(fingerprint, device, "the replicated state's counters and generator")


def digest(t: torch.Tensor) -> int:
    """CRC-32 of a host tensor's bytes (a generator's state), for a
    fingerprint."""
    return zlib.crc32(t.cpu().numpy().tobytes())


def shard_batch(batch: torch.Tensor, rank: Optional[int] = None,
                size: Optional[int] = None) -> torch.Tensor:
    """Rank `rank`'s contiguous block of the batch's rows, in rank order
    (JAX's `P(DATA_AXIS)` layout); the group's rank and size by default.
    The batch divides evenly over the ranks."""
    if rank is None or size is None:
        rank, size = world()
    n = batch.shape[0]
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over {size} ranks")
    per = n // size
    return batch[rank * per:(rank + 1) * per]
