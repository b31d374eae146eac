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
| `create_volumetric_mesh(devices, d, s)`     | `create_volumetric_mesh(d, s)`: a grid of process groups |
| GSPMD's max over a sharded array (int8 scales) | `VolumetricMesh.pmax`             |
| GSPMD's sums over a sharded volume          | `psum`, `psum_differentiable` over a mesh's group |

As in JAX, a module or step built with `axis_name=DATA_AXIS` averages over
the ranks and one built with None stays local. With no process group the
collectives are the identity (one rank), so a step built for the group runs
unchanged, bit for bit, without one. Each collective takes a `group=`
(None: the default group); the volumetric mesh's groups are its rows and
columns.

`collectives` counts the all-reduces, broadcasts and point-to-point
messages issued and the bytes they carried, as `ops._build.launches`
counts kernel launches. `collective_log`, when a list, also records each
collective as (kind, group size, shape) in issue order, so that ranks can
be held to issuing the same ones in the same order.

The partitioned services (`cli/serve_http.py`, `cli/run_recon.py`) are one
process a rank where the JAX package is one process: rank 0 takes the
requests and sends each to the other ranks (`broadcast_request`), which
follow it (`follow_requests`) until it sends "stop". A follower waits
inside that broadcast for as long as no request comes, and a collective
left waiting past its group's timeout ends the rank (gloo's timeout,
NCCL's watchdog), so an idle rank 0 sends a "tick" once a quarter of the
timeout has passed since its last collective. A collective that fails once
a request is out leaves the ranks in different collectives: the service
then ends on every rank (`RankFailure`). `Leader` is rank 0's side of that
protocol; the timeout is the one the group was made with here
(`init_process_group`).
"""

import collections
import contextlib
import datetime
import os
import threading
import time
import weakref
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"

collectives: collections.Counter = collections.Counter()
collective_log: Optional[list] = None


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
    init_process_group(backend, "env://", rank, size)
    return True


# (a weak reference to the default group, its timeout in seconds) of the
# last `init_process_group`
_made = None


def init_process_group(backend: str, init_method: str, rank: int, world_size: int,
                       timeout_s: Optional[float] = None) -> None:
    """`dist.init_process_group` with the timeout `timeout_s` (None:
    PyTorch's default for `backend`), recorded for `group_timeout`."""
    global _made
    from torch.distributed import constants

    if timeout_s is None:
        default = constants.default_pg_timeout
        if backend == "nccl":
            default = getattr(constants, "default_pg_nccl_timeout", None) or default
        timeout_s = default.total_seconds()
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    _made = (weakref.ref(dist.group.WORLD), float(timeout_s))


def group_timeout() -> float:
    """Seconds a collective of the default group may wait for its peers
    before the backend ends it. RuntimeError unless the group was made by
    `init_process_group`, which records it."""
    if _made is None or _made[0]() is None or _made[0]() is not dist.group.WORLD:
        raise RuntimeError("the default process group's timeout is unknown: make the group "
                           "with parallel/mesh.py::init_process_group")
    return _made[1]


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


def group_size(group=None) -> int:
    """Ranks in `group` (None: the default group); 1 without a group."""
    return dist.get_world_size(group) if is_active() else 1


def count(kind: str, t: torch.Tensor, group=None, log: bool = True) -> None:
    """Add one `kind` collective of `t`'s bytes to `collectives` (and, with
    `log`, to `collective_log` when it is a list)."""
    collectives[kind] += 1
    collectives[kind + "_bytes"] += t.numel() * t.element_size()
    if log and collective_log is not None:
        collective_log.append((kind, group_size(group), tuple(t.shape)))


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> None:
    count("all_reduce", t, group)
    dist.all_reduce(t, op, group=group)


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


def pmean(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`lax.pmean` over the ranks of `group` (None: the default group): each
    tensor's mean over the ranks, from one all-reduce (sum) of their
    concatenation divided by the group's size. The results are views of one
    new buffer; the inputs are not changed. All tensors share one dtype and
    device. Without a group (or with no tensors) the tensors come back as
    given. Outside autograd: see `pmean_differentiable`."""
    tensors = list(tensors)
    if not is_active() or not tensors:
        return tensors
    flat = _flatten([t.detach() for t in tensors])
    _all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return _split(flat, tensors)


def psum(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`lax.psum` over the ranks of `group`: `pmean` without the division
    (one all-reduce of the concatenation). Outside autograd."""
    tensors = list(tensors)
    if not is_active() or not tensors:
        return tensors
    flat = _flatten([t.detach() for t in tensors])
    _all_reduce(flat, group=group)
    return _split(flat, tensors)


class _AllReduce(torch.autograd.Function):
    """Sum or mean over the ranks of a group, forward and backward: the
    cotangent of a psum (pmean) is the psum (pmean) of the ranks'
    cotangents (the transposes in the JAX package's `shard_map`), so each
    rank's gradient takes in the other ranks' losses through the shared
    statistics."""

    @staticmethod
    def forward(ctx, flat, group, mean):
        ctx.group, ctx.mean = group, mean
        out = flat.clone()
        _all_reduce(out, group=group)
        return out.div_(dist.get_world_size(group)) if mean else out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        _all_reduce(grad, group=ctx.group)
        if ctx.mean:
            grad.div_(dist.get_world_size(ctx.group))
        return grad, None, None


def pmean_differentiable(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`pmean` inside autograd: one all-reduce forward and one backward (a
    synced batch norm's mean and mean of squares). Without a group, the
    tensors as given."""
    tensors = list(tensors)
    if not is_active() or not tensors:
        return tensors
    return _split(_AllReduce.apply(_flatten(tensors), group, True), tensors)


def psum_differentiable(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """`psum` inside autograd: one all-reduce (sum) forward, and one of the
    cotangents backward (a sharded instance norm's sums). Without a group,
    the tensors as given."""
    tensors = list(tensors)
    if not is_active() or not tensors:
        return tensors
    return _split(_AllReduce.apply(_flatten(tensors), group, False), tensors)


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
            count("broadcast", t)
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


SPATIAL_AXIS = "spatial"


class VolumetricMesh:
    """A `data × spatial` grid of the ranks (JAX `train/volumetric.py`'s
    `Mesh(devices.reshape(data, spatial), ('data', 'spatial'))`): rank r
    sits at (r // spatial, r % spatial), so the ranks of one row share a
    batch block and split its depth, and the ranks of one column share a
    depth block. `world_group` is the default group, `spatial_group` this
    rank's row, `data_group` its column (all None without a process group,
    where the mesh is 1 × 1 and every collective the identity, even under a
    process group made for something else).

    The same mesh splits 2-D maps (the partitioned edit decode,
    `cli/edit_batch.py`): a (B, H, W) map's rows take the depth's place, so
    `block` and `gather` with their defaults split and join the batch over
    `data` and the rows over `spatial` (JAX's `P('data', 'spatial')` on the
    id maps). A mesh of `data × 1` splits the batch only.

    The mesh is shared, never copied: `copy.deepcopy` of a module that
    holds it keeps the same mesh."""

    def __init__(self, data: int, spatial: int, rank: int = 0, world_group=None,
                 data_group=None, spatial_group=None):
        self.data, self.spatial = int(data), int(spatial)
        self.size = self.data * self.spatial
        self.rank = int(rank)
        self.coords = (self.rank // self.spatial, self.rank % self.spatial)
        self.world_group = world_group
        self.data_group = data_group
        self.spatial_group = spatial_group

    def __repr__(self):
        return (f"VolumetricMesh(data={self.data}, spatial={self.spatial}, rank={self.rank}, "
                f"coords={self.coords})")

    def __deepcopy__(self, memo):
        return self

    @property
    def neighbours(self) -> Tuple[Optional[int], Optional[int]]:
        """The global ranks holding the depth blocks before and after this
        rank's in its row (None at the volume's ends)."""
        s = self.coords[1]
        return (self.rank - 1 if s > 0 else None,
                self.rank + 1 if s < self.spatial - 1 else None)

    def psum(self, tensors: Sequence[torch.Tensor], axis: str = "world") -> List[torch.Tensor]:
        """`psum` over all the mesh's ranks ("world"), this rank's row
        ("spatial") or its column ("data"); the tensors as given on a mesh
        made without a process group, whatever group may exist."""
        if self.world_group is None:
            return list(tensors)
        group = {"world": self.world_group, SPATIAL_AXIS: self.spatial_group,
                 DATA_AXIS: self.data_group}[axis]
        return psum(tensors, group)

    def pmax(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """`t`'s elementwise maximum over all the mesh's ranks ("world"), this
        rank's row or its column: one all-reduce (MAX) of a copy; `t` as
        given on a mesh made without a process group."""
        if self.world_group is None:
            return t
        group = {"world": self.world_group, SPATIAL_AXIS: self.spatial_group,
                 DATA_AXIS: self.data_group}[axis]
        out = t.clone()
        _all_reduce(out, dist.ReduceOp.MAX, group)
        return out

    def block(self, x, batch_axis: int = 0, depth_axis: int = 1):
        """This rank's block of a global (B, D, ...) array or tensor (D a
        volume's depth or a map's rows): samples [d·B/data, (d+1)·B/data)
        and slabs [s·D/spatial, (s+1)·D/spatial) (JAX's `P('data',
        'spatial')`). Both divide evenly (ValueError where they do not)."""
        d, s = self.coords
        for axis, parts, what in ((batch_axis, self.data, "batch"),
                                  (depth_axis, self.spatial, "depth")):
            if x.shape[axis] % parts:
                raise ValueError(f"a {what} of {x.shape[axis]} does not split over "
                                 f"{parts} ranks of the mesh's {what} axis")
        nb, nd = x.shape[batch_axis] // self.data, x.shape[depth_axis] // self.spatial
        index = [slice(None)] * len(x.shape)
        index[batch_axis] = slice(d * nb, (d + 1) * nb)
        index[depth_axis] = slice(s * nd, (s + 1) * nd)
        return x[tuple(index)]

    def gather(self, local: torch.Tensor, batch_axis: int = 0,
               depth_axis: int = 1) -> torch.Tensor:
        """The global array from every rank's `block` (the inverse of
        `block`), on every rank: one all-reduce (sum) over the world of a
        zero buffer holding each rank's block in its place. Exact, as
        `all_gather_rows` (gloo reduces CUDA tensors where it gathers
        none). Without a group, `local`."""
        if self.world_group is None or not is_active():
            return local
        shape = list(local.shape)
        shape[batch_axis] *= self.data
        shape[depth_axis] *= self.spatial
        buf = local.new_zeros(shape)
        d, s = self.coords
        nb, nd = local.shape[batch_axis], local.shape[depth_axis]
        index = [slice(None)] * len(shape)
        index[batch_axis] = slice(d * nb, (d + 1) * nb)
        index[depth_axis] = slice(s * nd, (s + 1) * nd)
        buf[tuple(index)] = local
        _all_reduce(buf, group=self.world_group)
        return buf


def create_volumetric_mesh(data: int, spatial: int) -> VolumetricMesh:
    """The `data × spatial` mesh over the default group's ranks (JAX
    `create_volumetric_mesh`): one new process group for each row (the
    `spatial` axis) and each column (the `data` axis), made on every rank
    in the same order. `data · spatial` must equal the world size
    (ValueError); without a process group only 1 × 1 is possible, and it is
    the identity."""
    data, spatial = int(data), int(spatial)
    if data < 1 or spatial < 1:
        raise ValueError(f"mesh {data}x{spatial}: both axes need at least one rank")
    rank, size = world()
    if data * spatial != size:
        raise ValueError(f"a data={data} x spatial={spatial} mesh needs {data * spatial} "
                         f"ranks; the process group has {size}")
    if not is_active():
        return VolumetricMesh(1, 1)
    rows = [dist.new_group([i * spatial + j for j in range(spatial)]) for i in range(data)]
    cols = [dist.new_group([i * spatial + j for i in range(data)]) for j in range(spatial)]
    return VolumetricMesh(data, spatial, rank, dist.group.WORLD, cols[rank % spatial],
                          rows[rank // spatial])


@contextlib.contextmanager
def torchrun_mesh(data: Optional[int], spatial: Optional[int], device="cuda"):
    """`create_volumetric_mesh(data, spatial)` over torchrun's process group,
    made here from its environment (`initialize_distributed`) and destroyed
    on exit unless it existed before; `spatial` None puts every rank on the
    spatial axis, `data` None every rank on the data axis."""
    owned = initialize_distributed(device)
    try:
        size = world()[1]
        yield create_volumetric_mesh(size if data is None else data,
                                     size if spatial is None else spatial)
    finally:
        if owned:
            destroy_distributed()


# the requests rank 0 of a partitioned service sends to the other ranks
REQUEST_OPS = ("edit", "stop", "tick")


class RankFailure(RuntimeError):
    """A partitioned service's collective failed after rank 0 sent its
    request: the ranks may be left inside different collectives, so the
    service ends on every rank (a follower with the error, or when rank 0's
    process is gone) instead of serving on."""


def broadcast_request(op: Optional[str] = None, ids=None, flag: int = 0):
    """Rank 0 sends one request of a partitioned service to every rank of
    the default group; the other ranks call it without arguments and
    receive it. A header of five int64 (the op's index in REQUEST_OPS, the
    flag, B, H, W), then for "edit" the (B, H, W) int32 maps, each one
    counted broadcast, on the current card under NCCL (which moves device
    memory only), on the host under gloo. → (op, flag, maps: an int32
    tensor for "edit", else None) on every rank. RuntimeError without a
    process group."""
    if not is_active():
        raise RuntimeError("broadcast_request needs a process group")
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    leader = dist.get_rank() == 0
    if leader:
        if op not in REQUEST_OPS:
            raise ValueError(f"request op {op!r}: one of {REQUEST_OPS}")
        shape = tuple(ids.shape) if op == "edit" else (0, 0, 0)
        if len(shape) != 3:
            raise ValueError(f"a request's maps are (B, H, W), got {shape}")
        header = torch.tensor([REQUEST_OPS.index(op), int(flag), *shape], dtype=torch.int64,
                              device=dev)
    else:
        header = torch.empty(5, dtype=torch.int64, device=dev)
    count("broadcast", header)
    dist.broadcast(header, src=0)
    code, flag, *shape = header.tolist()
    op = REQUEST_OPS[code]
    if op != "edit":
        return op, flag, None
    if leader:
        maps = torch.as_tensor(ids).to(dev, torch.int32).contiguous()
    else:
        maps = torch.empty(shape, dtype=torch.int32, device=dev)
    count("broadcast", maps)
    dist.broadcast(maps, src=0)
    return op, flag, maps


def follow_requests(handle) -> collections.Counter:
    """A follower (rank > 0) of a partitioned service: receive rank 0's
    requests (`broadcast_request`), run `handle(flag, maps)` for each
    "edit", pass over each "tick", and return at "stop" with the count of
    each op received. An error of `handle` or of a collective propagates:
    it ends the follower."""
    seen = collections.Counter()
    while True:
        op, flag, maps = broadcast_request()
        seen[op] += 1
        if op == "stop":
            return seen
        if op == "edit":
            handle(flag, maps)


class Leader:
    """Rank 0 of a partitioned service: sends each request to the other
    ranks and runs its own part of it (`send`), one request at a time; a
    thread of its own sends a "tick" once a quarter of the default group's
    timeout (`tick_seconds`) has passed since its last collective; `close`
    sends "stop". Once a request failed (`failed`: its error) the service
    has ended: every later `send` raises `RankFailure`, and `close` sends
    nothing, since the other ranks may be inside another collective and end
    with the failure. `device`: the card of an NCCL group's header (None:
    the current one), whichever thread sends."""

    def __init__(self, device=None):
        self.tick_seconds = group_timeout() / 4
        self.failed = None
        self._closed = False
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._card = dev if dev is not None and dev.type == "cuda" else None
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._closing = threading.Event()
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True, name="leader-tick")
        self._ticker.start()

    def send(self, op: str, ids=None, flag: int = 0, work=None):
        """Send request `op` (for "edit" the (B, H, W) maps `ids` and
        `flag`), then run `work(maps)`, this rank's part, which joins the
        other ranks' collectives → what `work` returns. An error of either
        ends the service: `RankFailure`."""
        with self._lock:
            return self._send(op, ids, flag, work)

    def _send(self, op, ids, flag, work):
        if self._closed:
            raise RuntimeError("the partitioned service is closed")
        if self.failed is not None:
            raise RankFailure("the partitioned service has ended") from self.failed
        try:
            with (torch.cuda.device(self._card) if self._card is not None
                  else contextlib.nullcontext()):
                maps = broadcast_request(op, ids, flag)[2]
                return None if work is None else work(maps)
        except Exception as e:
            self.failed = e
            raise RankFailure(f"the partitioned {op} failed ({type(e).__name__}: {e}); the "
                              "service ends on every rank") from e
        finally:
            self._last = time.monotonic()

    def _tick_loop(self):
        while not self._closing.wait(self.tick_seconds / 4):
            with self._lock:
                if (self.failed is None and not self._closed
                        and time.monotonic() - self._last >= self.tick_seconds):
                    with contextlib.suppress(RankFailure):
                        self._send("tick", None, 0, None)

    def close(self) -> None:
        """Stop ticking and send "stop", unless a request failed."""
        self._closing.set()
        self._ticker.join()
        with self._lock:
            try:
                if self.failed is None and not self._closed:
                    self._send("stop", None, 0, None)
            finally:
                self._closed = True
