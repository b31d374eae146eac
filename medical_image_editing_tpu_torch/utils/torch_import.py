"""Import a reference-format Lightning `.ckpt` into the port's models.

Counterpart of `medical_image_editing_tpu/utils/torch_import.py`
(`load_reference_ckpt` `:70`, `is_lightning_ckpt` `:104`, `read_ckpt_meta`
`:156`). The file's `state_dict` nests each model under its trainer
attribute (`encoder.`, `decoder.`, `discriminator.`); the port's modules
carry the reference's keys (`utils/weights.py`), so a group loads as it
is, read by `utils/weights.py::load_lightning_ckpt`. The import is strict,
as the JAX package's: every key of a group must be consumed and every
tensor of the model filled, with the same shapes, except
`num_batches_tracked` bookkeeping (taken where present, kept where not),
the U-Net discriminator's unused `linear.*` (consumed and dropped), and
ActNorm's data-init buffers, which a reference file folds into `loc` and
`scale` (`models/actnorm.py` sets them to 0 and 1).
"""

import os
from typing import Dict, Tuple

import torch
from torch import nn

from ..models.unet_discriminator import UNetDiscriminator, reference_state_dict
from .weights import load_lightning_ckpt

StateDict = Dict[str, torch.Tensor]
GROUPS = ("encoder", "decoder", "discriminator")

__all__ = ["load_reference_ckpt", "read_ckpt_meta", "is_lightning_ckpt", "is_vqgan_group",
           "import_module", "GROUPS"]


def load_reference_ckpt(path: str) -> Tuple[Dict[str, StateDict], Dict[str, int]]:
    """One read of a `.ckpt` → (per-model groups, {"epoch", "step"})."""
    return load_lightning_ckpt(path)


def read_ckpt_meta(path: str) -> Dict[str, int]:
    """{"epoch", "step"} of a `.ckpt` (0 where the file has none)."""
    return load_lightning_ckpt(path)[1]


def is_lightning_ckpt(path: str) -> bool:
    """A reference checkpoint is one `.ckpt` file; the port's checkpoints
    are directories."""
    return os.path.isfile(path)


def is_vqgan_group(group: StateDict) -> bool:
    """Whether a `decoder` group holds a whole VQGAN (the VQGAN trainer's
    decoder field) rather than a U-Net decoder."""
    return "encoder.conv_in.weight" in group


def _internal(key: str) -> bool:
    """Model tensors a reference file need not hold."""
    return key.endswith(("num_batches_tracked", ".data_loc", ".data_scale"))


def _scalar_as(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A one-element tensor in the model's shape: the JAX package's export
    writes 0-d values (`num_batches_tracked`, attention's `gamma`) as (1,)."""
    if v.numel() == 1 and like.numel() == 1 and v.shape != like.shape:
        return v.reshape(like.shape)
    return v


def import_module(module: nn.Module, group: StateDict, what: str) -> nn.Module:
    """Load one group into `module`, strictly (module note); raises
    `ValueError` naming unconsumed, missing or misshapen keys."""
    if isinstance(module, UNetDiscriminator):
        group = reference_state_dict(group)
    own = module.state_dict()
    left = sorted(k for k in group if k not in own and not k.endswith("num_batches_tracked"))
    if left:
        raise ValueError(f"{what}: {len(left)} reference key(s) were not consumed "
                         f"(architecture mismatch?): {left[:8]}{' ...' if len(left) > 8 else ''}")
    missing = sorted(k for k in own if k not in group and not _internal(k))
    if missing:
        raise ValueError(f"{what}: the checkpoint is missing {len(missing)} key(s) of the "
                         f"configured model: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    sd = {k: _scalar_as(v, own[k]) for k, v in group.items() if k in own}
    bad = [f"{k}: ckpt{tuple(sd[k].shape)} vs model{tuple(own[k].shape)}"
           for k in own if k in sd and tuple(sd[k].shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"{what}: shape mismatches: {bad[:6]}")
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module
