"""Sharding of activations along one spatial axis: the halo exchange and
the statistics a sharded convolution and instance norm need.

The JAX package has no counterpart module: its volumetric step and decode
(`train/volumetric.py`, `cli/edit_volume.py`) annotate the volume as
`P('data', 'spatial')`, its partitioned 2-D edit decode
(`cli/edit_batch.py`, `partition="spatial"`) each map's rows, and GSPMD
inserts the halo exchanges and makes every statistic global. This module
stands in for what GSPMD inserts there. A rank of a
`parallel.mesh.VolumetricMesh` row holds blocks [s·L/S, (s+1)·L/S) of the
sharded axis (a volume's depth, a 2-D map's rows) of every sample of its
batch block:

* `halo(x, mesh, width, axis)`: `width` rows of the sharded `axis` from
  the ranks before this one in front and from the ranks after it behind
  (zeros past the image's ends, a SAME convolution's padding), so that a
  convolution reaching `width` rows each way, with padding 0 on that axis,
  gives this rank's rows of the unsharded convolution. A halo wider than
  the blocks reaches past the neighbour: the rows come from as many ranks
  as the width needs, each sending its own. Its backward sends each halo
  row's cotangent back to the rank that owns the row, which adds it in.
* `instance_norm_sharded(x, mesh)`: per-sample, per-channel statistics
  over the whole sharded axis: the sum all-reduced over the row for the
  mean, then the centred sum of squares for the biased variance, in
  float32, eps 1e-5 (JAX `models/volumetric.py::instance_norm_3d` on the
  global volume, `models/blocks.py::instance_norm` on the global map).

The messages: under NCCL, `batch_isend_irecv` on the tensors where they
lie. Under gloo a CUDA tensor is staged through host memory (gloo's
send/recv hand the tensor's pointer to its host transport, which cannot
read device memory); a CPU tensor goes as it is. Each exchange counts one
`collectives` "send" and "recv" a peer (a rank within `width` rows), and
logs one `collective_log` entry ("halo", 2, shape) on every rank of the
row, edges included.
"""

from typing import Dict, List

import torch
import torch.distributed as dist

from . import mesh as _mesh


def _exchange(sends: Dict[int, torch.Tensor], group) -> Dict[int, torch.Tensor]:
    """Send `sends[peer]` to each global rank `peer` of `group` and receive a
    tensor of the same shape and dtype back from it; returns {peer:
    received}, on the senders' device."""
    if not sends:
        return {}
    staged = dist.get_backend(group) != "nccl"
    ops, bufs = [], {}
    for peer, t in sends.items():
        out = t.detach().to("cpu" if staged else t.device).contiguous()
        bufs[peer] = torch.empty_like(out)
        ops.append(dist.P2POp(dist.isend, out, peer, group))
        ops.append(dist.P2POp(dist.irecv, bufs[peer], peer, group))
        _mesh.count("send", out, log=False)
        _mesh.count("recv", out, log=False)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {peer: b.to(sends[peer].device) for peer, b in bufs.items()}


def _log_halo(x: torch.Tensor) -> None:
    if _mesh.collective_log is not None:
        _mesh.collective_log.append(("halo", 2, tuple(x.shape)))


def hop_rows(n: int, width: int) -> List[int]:
    """Rows a halo of `width` takes from the k-th rank each way, k = 1, 2, ...,
    for blocks of `n` rows: whole blocks, then the rest."""
    return [min(n, width - k * n) for k in range(-(-width // n))]


def _peers(mesh, hops):
    """(rows, the rank k before or None, the rank k after or None) for each
    hop k = 1, 2, ...: None past the image's ends."""
    s = mesh.coords[1]
    return [(c, mesh.rank - k if s - k >= 0 else None,
             mesh.rank + k if s + k < mesh.spatial else None)
            for k, c in enumerate(hops, 1)]


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, width, axis):
        ctx.mesh, ctx.width, ctx.axis = mesh, width, axis
        n = x.shape[axis]
        peers = _peers(mesh, hop_rows(n, width))
        sends = {}
        for c, before, after in peers:
            if before is not None:  # my first rows end its halo behind
                sends[before] = x.narrow(axis, 0, c)
            if after is not None:  # my last rows end its halo in front
                sends[after] = x.narrow(axis, n - c, c)
        _log_halo(x)
        got = _exchange(sends, mesh.spatial_group)

        def piece(peer, c):
            if peer is not None:
                return got[peer]
            shape = list(x.shape)
            shape[axis] = c
            return x.new_zeros(shape)

        front = [piece(before, c) for c, before, _ in reversed(peers)]
        behind = [piece(after, c) for c, _, after in peers]
        return torch.cat(front + [x] + behind, axis)

    @staticmethod
    def backward(ctx, grad):
        mesh, width, axis = ctx.mesh, ctx.width, ctx.axis
        n = grad.shape[axis] - 2 * width
        peers = _peers(mesh, hop_rows(n, width))
        sends, front, behind = {}, width, width + n
        for c, before, after in peers:
            front -= c
            if before is not None:
                sends[before] = grad.narrow(axis, front, c)
            if after is not None:
                sends[after] = grad.narrow(axis, behind, c)
            behind += c
        _log_halo(grad)
        got = _exchange(sends, mesh.spatial_group)
        dx = grad.narrow(axis, width, n).clone()
        for c, before, after in peers:
            if before is not None:
                dx.narrow(axis, 0, c).add_(got[before])
            if after is not None:
                dx.narrow(axis, n - c, c).add_(got[after])
        return dx, None, None, None


def halo(x: torch.Tensor, mesh, width: int = 1, axis: int = 2) -> torch.Tensor:
    """`x` with `width` rows of the sharded `axis` added at each end, from
    the ranks before and after this one in the mesh's row (zeros past the
    image's ends): (N, C, L_local, ...) → (N, C, L_local + 2·width, ...) on
    axis 2. Differentiable."""
    if width < 1:
        raise ValueError(f"a halo of {width} rows")
    return _Halo.apply(x, mesh, int(width), int(axis))


def instance_norm_sharded(x: torch.Tensor, mesh, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of (N, C, L_local, ...) shards (a volume's depth slabs,
    a map's rows) with the whole image's per-sample, per-channel statistics:
    the sum and then the centred sum of squares all-reduced over the mesh's
    row (differentiable), mean and biased variance over every pixel, in
    float32; the result in x.dtype."""
    xf = x.float()
    dims = tuple(range(2, x.dim()))
    lift = (slice(None), slice(None)) + (None,) * len(dims)
    n = float(xf[0, 0].numel() * mesh.spatial)
    (total,) = _mesh.psum_differentiable([xf.sum(dims)], mesh.spatial_group)
    centred = xf - (total / n)[lift]
    (ssq,) = _mesh.psum_differentiable([(centred * centred).sum(dims)], mesh.spatial_group)
    return (centred * torch.rsqrt(ssq / n + eps)[lift]).to(x.dtype)
