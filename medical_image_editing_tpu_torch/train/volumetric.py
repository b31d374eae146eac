"""The 3-D volumetric training step (BASELINE config #5).

Counterpart of `medical_image_editing_tpu/train/volumetric.py`: the
reconstruction MSE plus the commit loss of the volumetric VQ-WNet, one
backward, both Adams stepped, the codebook's EMA update returned. The JAX
step is functional; here the modules and optimizers are updated in place and
the step returns the new codebook state and the metrics.

The JAX package's ('data', 'spatial') mesh, which shards volumes over
batch and depth (`create_volumetric_mesh`, `mesh=`), is multi-card: ROADMAP
item 15(iii). A mesh is refused, and so is a run under more than one rank
(`refuse_ranks`), which would train unsynchronised copies.
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
from ..utils.device import resolve_device
from .state import make_optimizer

MESH_REFUSAL = ("the volumetric depth sharding ('data', 'spatial' mesh) is multi-card, "
                "ROADMAP item 15(iii), and not ported: run on one device")


def refuse_mesh(mesh) -> None:
    """Raise `ValueError` (naming ROADMAP item 15(iii)) for a non-None mesh."""
    if mesh is not None:
        raise ValueError(f"mesh {mesh!r}: {MESH_REFUSAL}")


def refuse_ranks() -> None:
    """Raise `ValueError` (naming ROADMAP item 15(iii)) under more than one
    rank: torchrun's `WORLD_SIZE` or a process group."""
    from ..parallel.mesh import world

    size = max(world()[1], int(os.environ.get("WORLD_SIZE") or 1))
    if size > 1:
        raise ValueError(f"{size} ranks: the volumetric trainer is not data parallel; "
                         f"{MESH_REFUSAL}")


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
    a tensor on any device."""
    refuse_mesh(mesh)
    dev = next(encoder.parameters()).device

    def step(vq_state: VQState, volume):
        volume = torch.as_tensor(volume, device=dev)
        enc_opt.zero_grad(set_to_none=True)
        dec_opt.zero_grad(set_to_none=True)
        recon, commit, _, new_vq = volumetric_forward(
            encoder, decoder, vq_state, volume, momentum=momentum, train=True)
        l_recon = torch.mean((recon - volume.float()) ** 2)
        total = l_recon + w_commit * commit
        total.backward()
        enc_opt.step()
        dec_opt.step()
        return new_vq, {"total": total.detach(), "recon": l_recon.detach(),
                        "commit": commit.detach()}

    return step
