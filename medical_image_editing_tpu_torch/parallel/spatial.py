"""Depth sharding of 3-D activations: the halo exchange and the statistics
a sharded 3×3×3 convolution and instance norm need.

The JAX package has no counterpart module: its volumetric step and decode
(`train/volumetric.py`, `cli/edit_volume.py`) annotate the volume as
`P('data', 'spatial')` and GSPMD inserts the halo exchanges and makes every
statistic global. This module stands in for what GSPMD inserts there. A
rank of a `parallel.mesh.VolumetricMesh` row holds slabs
[s·D/S, (s+1)·D/S) of every volume of its batch block:

* `depth_halo(x, mesh)`: (N, C, D_local, H, W) → (N, C, D_local + 2, H, W),
  the previous rank's last slab in front and the next rank's first slab
  behind (zeros at the volume's ends, a SAME convolution's padding), so
  that a 3×3×3 convolution with depth padding 0 gives this rank's slabs of
  the unsharded convolution. Its backward sends each halo's cotangent back
  to the rank that owns the slab, which adds it to its boundary slab.
* `instance_norm_sharded(x, mesh)`: per-sample, per-channel statistics
  over the whole depth: the sum all-reduced over the row for the mean, then
  the centred sum of squares for the biased variance, in float32, eps 1e-5
  (JAX `models/volumetric.py::instance_norm_3d` on the global volume).

The messages: under NCCL, `batch_isend_irecv` on the tensors where they
lie. Under gloo a CUDA tensor is staged through host memory (gloo's
send/recv hand the tensor's pointer to its host transport, which cannot
read device memory); a CPU tensor goes as it is. Each exchange counts one
`collectives` "send" and "recv" a neighbour, and logs one `collective_log`
entry ("halo", 2, shape) on every rank of the row, edges included.
"""

from typing import Dict

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


class _DepthHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        prev, nxt = mesh.neighbours
        sends = {}
        if prev is not None:
            sends[prev] = x[:, :, :1]
        if nxt is not None:
            sends[nxt] = x[:, :, -1:]
        _log_halo(x)
        got = _exchange(sends, mesh.spatial_group)
        zero = x.new_zeros(x.shape[:2] + (1,) + x.shape[3:])
        return torch.cat([got.get(prev, zero), x, got.get(nxt, zero)], 2)

    @staticmethod
    def backward(ctx, grad):
        prev, nxt = ctx.mesh.neighbours
        sends = {}
        if prev is not None:
            sends[prev] = grad[:, :, :1]
        if nxt is not None:
            sends[nxt] = grad[:, :, -1:]
        _log_halo(grad)
        got = _exchange(sends, ctx.mesh.spatial_group)
        dx = grad[:, :, 1:-1].clone()
        if prev is not None:
            dx[:, :, :1] += got[prev]
        if nxt is not None:
            dx[:, :, -1:] += got[nxt]
        return dx, None


def depth_halo(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` (N, C, D_local, H, W) with one slab of each depth neighbour's
    added at each end (zeros where the volume ends). Differentiable."""
    return _DepthHalo.apply(x, mesh)


def instance_norm_sharded(x: torch.Tensor, mesh, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of (N, C, D_local, H, W) depth shards with the whole
    volume's per-sample, per-channel statistics: the sum and then the centred
    sum of squares all-reduced over the mesh's row (differentiable), mean and
    biased variance over D·H·W voxels, in float32; the result in x.dtype."""
    xf = x.float()
    n = float(xf[0, 0].numel() * mesh.spatial)
    (total,) = _mesh.psum_differentiable([xf.sum((2, 3, 4))], mesh.spatial_group)
    centred = xf - (total / n)[:, :, None, None, None]
    (ssq,) = _mesh.psum_differentiable([(centred * centred).sum((2, 3, 4))],
                                       mesh.spatial_group)
    return (centred * torch.rsqrt(ssq / n + eps)[:, :, None, None, None]).to(x.dtype)
