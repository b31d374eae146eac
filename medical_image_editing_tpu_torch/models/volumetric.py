"""3-D volumetric VQ-WNet (BASELINE config #5: 128³ CT volumes).

Counterpart of `medical_image_editing_tpu/models/volumetric.py` (no
reference counterpart: the reference is strictly 2-D). A U-Net encoder of
3×3×3 convolutions producing full-resolution features, quantized by the same
EMA codebook machinery as the 2-D models (`ops/vq.py::vq_apply` with its
default, the plain assignment, as the JAX function calls it), and a mirrored decoder
with skip connections and a tanh output.

Layout: modules are NCDHW with (O, I, kd, kh, kw) weights; `volumetric_forward`
takes and returns NDHWC, like the JAX function. Submodules are named by the
flax variable paths (`ResBlock3D_{i}.Conv_0` the 1×1×1 identity,
`ResBlock3D_{i}.DoubleConv3D_0.Conv_{0,1}`, `DoubleConv3D_0`,
`UpBlock3D_{j}.DoubleConv3D_0`, the decoder's head `Conv_0`), so a state
dict's keys are the JAX tree's paths (`utils/weights.py::from_jax_volumetric`).

Compute dtype, as flax's `dtype=`: parameters stay float32 and each
convolution casts its input, weight and bias to the compute dtype (by default
the promotion of input and weight dtypes); the U-Net body casts its input to
it first; instance norm reduces in float32 and casts back; the skip is cast
to the upsampled tensor's dtype before the concat; the decoder's tanh is
taken in float32. Autocast does none of these the same way, so the casts are
explicit.

`use_remat` runs each block under `torch.utils.checkpoint` (non-reentrant)
while gradients are on: the block's inner activations are dropped on the
forward pass and recomputed in the backward. It changes peak memory only,
never values or parameter names (the JAX package's per-block `nn.remat`).

Depth sharding (the JAX package's `P('data', 'spatial')` volumes under
GSPMD): `set_mesh(mesh)` with a `parallel.mesh.VolumetricMesh` of more than
one rank on its spatial axis makes each 3×3×3 convolution run on its input
with a halo of one slab from each depth neighbour (`parallel/spatial.py`),
depth padding 0 and H/W padding 1, and each instance norm take the whole
volume's statistics; the 1×1×1 convolutions, max-pools, upsampling and skip
concats stay local. Each rank's depth block must then be divisible by 2^n,
n the pooling levels (GSPMD would reshard a volume that is not; here it is
refused). `volumetric_forward(..., mesh=)` also sums the VQ's EMA
statistics over all the mesh's ranks: under GSPMD the step is one global
computation and JAX's `volumetric_forward` passes no `axis_name`.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.vq import VQState, vq_apply
from ..parallel.spatial import halo, instance_norm_sharded
from .blocks import instance_norm


def instance_norm_3d(x, mesh=None):
    """Per-sample, per-channel over (D, H, W): biased variance, eps 1e-5
    inside the rsqrt, no affine, statistics in float32, the result in the
    input dtype. With a depth-sharding `mesh` (spatial axis > 1) the
    statistics are the whole depth's."""
    if mesh is not None:
        return instance_norm_sharded(x, mesh)
    return instance_norm(x)


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` with flax's compute-dtype semantics (`compute_dtype`
    None: the promotion of input and weight dtypes). With a depth-sharding
    `mesh` a 3×3×3 kernel runs on the depth-haloed input with depth padding
    0."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = None
        self.mesh = None

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        x, padding = x.to(dt), self.padding
        if self.mesh is not None and self.kernel_size[0] == 3:
            x, padding = halo(x, self.mesh), (0,) + tuple(self.padding[1:])
        return F.conv3d(x, self.weight.to(dt), b, self.stride, padding)


class DoubleConv3D(nn.Module):
    """(3×3×3 SAME conv with bias → instance norm → ReLU) ×2."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.mesh = None
        self.Conv_0 = Conv3d(cin, features, 3, padding=1)
        self.Conv_1 = Conv3d(features, features, 3, padding=1)

    def forward(self, x):
        for conv in (self.Conv_0, self.Conv_1):
            x = F.relu(instance_norm_3d(conv(x), self.mesh))
        return x


class ResBlock3D(nn.Module):
    """relu(DoubleConv3D(x) + IN(1×1×1 conv without bias)(x)), then a
    2×2×2 max-pool: returns (pooled, pre-pool output)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.mesh = None
        self.Conv_0 = Conv3d(cin, features, 1, bias=False)
        self.DoubleConv3D_0 = DoubleConv3D(cin, features)

    def forward(self, x):
        identity = instance_norm_3d(self.Conv_0(x), self.mesh)
        out = F.relu(self.DoubleConv3D_0(x) + identity)
        return F.max_pool3d(out, 2, 2), out


class UpBlock3D(nn.Module):
    """Nearest ×2 on D, H and W (each voxel repeated, as `jnp.repeat`),
    concat [up, skip], DoubleConv3D."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.DoubleConv3D_0 = DoubleConv3D(cin, features)

    def forward(self, down, skip):
        x = F.interpolate(down, scale_factor=2, mode="nearest")
        return self.DoubleConv3D_0(torch.cat([x, skip.to(x.dtype)], 1))


class _VolumetricUNet(nn.Module):
    """The encoder's and decoder's shared body: len(filters) − 1 ResBlock3D
    levels, a DoubleConv3D bottleneck, the UpBlock3Ds back to full
    resolution; (B, in_channels, D, H, W) → (B, filters[0], D, H, W)."""

    def __init__(self, in_channels: int, filters: Sequence[int], dtype, use_remat: bool):
        super().__init__()
        f = tuple(int(v) for v in filters)
        self.filters = f
        self.compute_dtype = dtype
        self.use_remat = bool(use_remat)
        self.mesh = None
        n = len(f) - 1
        cin = in_channels
        for i in range(n):
            setattr(self, f"ResBlock3D_{i}", ResBlock3D(cin, f[i]))
            cin = f[i]
        self.DoubleConv3D_0 = DoubleConv3D(cin, f[n])
        for j, i in enumerate(reversed(range(n))):
            setattr(self, f"UpBlock3D_{j}", UpBlock3D(f[i + 1] + f[i], f[i]))
        for m in self.modules():
            if isinstance(m, Conv3d):
                m.compute_dtype = dtype

    def set_mesh(self, mesh) -> None:
        """Shard depth over `mesh`'s spatial axis (a `VolumetricMesh`), or
        stop sharding (None, or a mesh of one rank on that axis, where
        every layer is the unsharded one). The mesh is set on every block,
        norm and 3×3×3 convolution; the state dict does not change."""
        mesh = mesh if mesh is not None and mesh.spatial > 1 else None
        self.mesh = mesh
        for m in self.modules():
            if isinstance(m, (Conv3d, DoubleConv3D, ResBlock3D)):
                m.mesh = mesh

    def _block(self, block, *args):
        if self.use_remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def body(self, x):
        n = len(self.filters) - 1
        spatial = self.mesh.spatial if self.mesh is not None else 1
        if any(s % 2**n for s in x.shape[2:]):
            shape = (x.shape[2] * spatial,) + tuple(x.shape[3:])
            if spatial > 1 and not any(s % 2**n for s in x.shape[3:]):
                raise ValueError(
                    f"depth {shape[0]} over spatial={spatial} ranks is {x.shape[2]} slabs a "
                    f"rank, not divisible by 2^{n} = {2**n} ({n} pooling levels of filters "
                    f"{self.filters}): each rank's depth block must be")
            raise ValueError(
                f"volume {'x'.join(str(s) for s in shape)} is not divisible by "
                f"2^{n} = {2**n} on every axis ({n} pooling levels of filters "
                f"{self.filters})"
            )
        x = x.to(self.compute_dtype or x.dtype)
        skips = []
        for i in range(n):
            x, skip = self._block(getattr(self, f"ResBlock3D_{i}"), x)
            skips.append(skip)
        x = self._block(self.DoubleConv3D_0, x)
        for j, i in enumerate(reversed(range(n))):
            x = self._block(getattr(self, f"UpBlock3D_{j}"), x, skips[i])
        return x


class VolumetricUNetEncoder(_VolumetricUNet):
    """x (B, in_channels, D, H, W) → features (B, filters[0], D, H, W)."""

    def __init__(self, in_channels: int = 1, filters: Sequence[int] = (8, 16, 32, 64),
                 dtype=None, use_remat: bool = False):
        super().__init__(in_channels, filters, dtype, use_remat)

    def forward(self, x):
        return self.body(x)


class VolumetricUNetDecoder(_VolumetricUNet):
    """Quantized embedding (B, filters[0], D, H, W) → tanh reconstruction
    (B, out_channels, D, H, W) in float32."""

    def __init__(self, out_channels: int = 1, filters: Sequence[int] = (8, 16, 32, 64),
                 dtype=None, use_remat: bool = False):
        super().__init__(filters[0], filters, dtype, use_remat)
        self.Conv_0 = Conv3d(self.filters[0], out_channels, 1)
        self.Conv_0.compute_dtype = dtype

    def forward(self, x):
        return torch.tanh(self.Conv_0(self.body(x)).float())


def volumetric_forward(
    encoder: VolumetricUNetEncoder,
    decoder: VolumetricUNetDecoder,
    vq_state: VQState,
    volume: torch.Tensor,
    *,
    momentum: float = 0.99,
    train: bool = True,
    mesh=None,
):
    """encode → VQ (voxels flattened) → decode, volume (B, D, H, W, C).

    Returns (recon (B, D, H, W, out) float32, commit, ids (B, D, H, W) + 1,
    new_vq). The features go to `vq_apply` as (B, D·H, W, C) rows in NDHWC
    order, the JAX function's 2-D contract, so each id lands in its voxel.
    `train=True` applies the EMA update to the returned state.

    With a `mesh` (`VolumetricMesh`; the models' `set_mesh` done by the
    caller) `volume` is this rank's block and so are the outputs, the EMA's
    counts and sums are summed over all the mesh's ranks (the global
    statistics), and `commit` is this rank's block's mean."""
    feats = encoder(volume.permute(0, 4, 1, 2, 3))
    b, c, d, h, w = feats.shape
    q, commit, ids, new_vq = vq_apply(
        vq_state, feats.permute(0, 2, 3, 4, 1).reshape(b, d * h, w, c),
        momentum=momentum, train=train,
        sum_group=None if mesh is None else mesh.world_group,
    )
    q = q.reshape(b, d, h, w, c).permute(0, 4, 1, 2, 3)
    recon = decoder(q).permute(0, 2, 3, 4, 1)
    return recon, commit, ids.reshape(b, d, h, w) + 1, new_vq
