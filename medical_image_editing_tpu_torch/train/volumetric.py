"""The 3-D volumetric training step (BASELINE config #5).

Counterpart of `medical_image_editing_tpu/train/volumetric.py`: the
reconstruction MSE plus the commit loss of the volumetric VQ-WNet, one
backward, both Adams stepped, the codebook's EMA update returned. The JAX
step is functional; here the modules and optimizers are updated in place and
the step returns the new codebook state and the metrics.

The JAX package's ('data', 'spatial') mesh shards the volumes over batch
and depth and lets GSPMD make the step one global computation. Here
`mesh=` (a `parallel.mesh.VolumetricMesh`, from `create_volumetric_mesh`
under `torchrun`, one process a card) does the same by hand: each rank
steps on its (batch block, depth block) of the global batch, the 3×3×3
convolutions exchange depth halos and the instance norms sum their
statistics over the rank's row (`parallel/spatial.py`), the VQ's EMA
statistics are summed over all ranks, each rank's backward gives its part
of the global loss's gradient, and one flattened all-reduce sums the parts.
Parameters, Adam states and codebook then stay bit for bit equal on every
rank. A run under more than one rank without a mesh is refused
(`refuse_ranks`): the JAX package has no such mode.
"""

import os
from typing import Optional

import torch

from ..models.blocks import seeded_init
from ..models.volumetric import (
    VolumetricUNetDecoder,
    VolumetricUNetEncoder,
    volumetric_forward,
)
from ..ops.vq import VQState
from ..parallel.mesh import VolumetricMesh, replicate
from ..utils.device import resolve_device
from .state import make_optimizer


def refuse_ranks() -> None:
    """Raise `ValueError` under more than one rank (torchrun's `WORLD_SIZE`
    or a process group) for a run without a mesh, which would train
    unsynchronised copies."""
    from ..parallel.mesh import world

    size = max(world()[1], int(os.environ.get("WORLD_SIZE") or 1))
    if size > 1:
        raise ValueError(f"{size} ranks without a mesh: the volumetric trainer shards over "
                         "a 'data,spatial' mesh (train_volumetric --mesh D,S with D·S ranks)")


def init_volumetric(generator: torch.Generator, *, filters=(8, 16, 32, 64),
                    dict_size: int = 10, volume_shape=(1, 16, 16, 16, 1), lr: float = 1e-4,
                    dtype=None, use_remat: bool = False, device="cuda"):
    """Build the encoder, decoder and codebook and their two Adams.

    `generator` (a CPU `torch.Generator`) fills the models as
    `models.blocks.seeded_init` does, then draws the random-normal codebook
    (`embed_avg` = `embed`, `cluster_size` 0, as the JAX `vq_init`).
    `volume_shape` is the JAX package's (B, D, H, W, C): its C is the input
    and output channel count. `dtype=torch.bfloat16` with `use_remat=True`
    is the JAX package's memory plan for 128³ (parameters stay float32).
    Returns (encoder, decoder, vq_state, enc_opt, dec_opt) on `device`."""
    dev = resolve_device(device)
    channels = int(volume_shape[-1])
    enc = VolumetricUNetEncoder(channels, filters, dtype=dtype, use_remat=use_remat)
    dec = VolumetricUNetDecoder(channels, filters, dtype=dtype, use_remat=use_remat)
    seeded_init(enc, generator)
    seeded_init(dec, generator)
    embed = torch.randn(dict_size, enc.filters[0], generator=generator)
    vq = VQState(embed.to(dev), torch.zeros(dict_size, device=dev), embed.clone().to(dev))
    enc, dec = enc.to(dev), dec.to(dev)
    return enc, dec, vq, make_optimizer(enc.parameters(), lr), make_optimizer(dec.parameters(), lr)


def make_volumetric_train_step(encoder: VolumetricUNetEncoder, decoder: VolumetricUNetDecoder,
                               enc_opt: torch.optim.Optimizer, dec_opt: torch.optim.Optimizer,
                               mesh: Optional[object] = None, momentum: float = 0.99,
                               w_commit: float = 1.0):
    """Returns step(vq_state, volume (B, D, H, W, C)) → (vq_state',
    metrics): loss mean((recon − volume)²) + w_commit · commit, one
    backward, both Adams stepped in place; metrics `total`, `recon` and
    `commit` as 0-d tensors on the device. `volume` may be a numpy array or
    a tensor on any device.

    With `mesh` (a `VolumetricMesh`) the models are set to it
    (`set_mesh`), their parameters and buffers broadcast from rank 0, and
    `volume` is this rank's block of the global batch (`mesh.block`). Each
    rank's losses are its block's means weighed by 1/mesh.size (the blocks
    are equal), so their sum over the ranks is the global mean; the
    backward of that share gives this rank's part of the global gradient,
    and one flattened all-reduce over the world sums the parts before the
    Adams step. The metrics are the global ones (one more all-reduce).
    Without a mesh (a 1 × 1 mesh) every weight is 1.0 and every sum the
    identity, and so on a mesh of one rank: bit for bit the unsharded
    step."""
    mesh = mesh or VolumetricMesh(1, 1)
    dev = next(encoder.parameters()).device
    params = [*encoder.parameters(), *decoder.parameters()]
    encoder.set_mesh(mesh)
    decoder.set_mesh(mesh)
    if mesh.world_group is not None:
        replicate([*params, *encoder.buffers(), *decoder.buffers()],
                  [len(params), sum(p.numel() for p in params)], device=dev)

    def step(vq_state: VQState, volume):
        volume = torch.as_tensor(volume, device=dev)
        enc_opt.zero_grad(set_to_none=True)
        dec_opt.zero_grad(set_to_none=True)
        recon, commit, _, new_vq = volumetric_forward(
            encoder, decoder, vq_state, volume, momentum=momentum, train=True, mesh=mesh)
        l_recon = torch.mean((recon - volume.float()) ** 2) * (1.0 / mesh.size)
        commit = commit * (1.0 / mesh.size)
        total = l_recon + w_commit * commit
        total.backward()
        with_grad = [p for p in params if p.grad is not None]
        for p, g in zip(with_grad, mesh.psum([p.grad for p in with_grad])):
            p.grad = g
        enc_opt.step()
        dec_opt.step()
        metrics = mesh.psum([total.detach(), l_recon.detach(), commit.detach()])
        return new_vq, dict(zip(("total", "recon", "commit"), metrics))

    return step
