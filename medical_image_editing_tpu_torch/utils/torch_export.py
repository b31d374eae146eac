"""Export the port's models as a reference-compatible Lightning `.ckpt`.

Counterpart of `medical_image_editing_tpu/utils/torch_export.py`: the file
holds `{'state_dict': {'encoder.…', 'decoder.…', 'discriminator.…'},
'epoch', 'global_step'}`, key for key what the JAX package's export writes,
so the reference's own modules, the JAX package's `import-ckpt` and the
port's `cli/import_ckpt.py` all load it strictly. The port's modules
already carry the reference's key space (`utils/weights.py`), so this is
repackaging; three models differ from their state dicts:

  * the U-Net discriminator gains the reference's `linear.*` layer, which
    its forward never uses (`weight`/`bias` zeros, `u0`/`sv0` ones), as the
    JAX export synthesizes it (`:272-281`);
  * the PatchGAN's ActNorms are folded: `loc + data_loc` and
    `scale · data_scale` under `loc` and `scale`, the data-init buffers
    dropped (the reference stores the folded values; importing sets them
    back to 0 and 1, the same affine bit for bit). Its spectral-norm convs
    keep `torch.nn.utils.spectral_norm`'s `weight_orig`, `weight_u` and
    `weight_v` (the port's own vectors: no forward reads `weight_v`);
  * the VQGAN sits in the `decoder` field with its codebook (`vq.*`, the
    reference's (C, K) `embed_avg`), and there is no encoder field.

Tensors go to the file on the CPU in their own dtypes (f32 parameters, the
ActNorm flag as uint8, `num_batches_tracked` as int64).
"""

from typing import Dict

import torch
from torch import nn

from ..models.actnorm import ActNorm
from ..models.discriminator import NLayerDiscriminator
from ..models.unet_discriminator import UNetDiscriminator, d_unet_arch

StateDict = Dict[str, torch.Tensor]

__all__ = ["export_module", "export_unet_discriminator", "export_nlayer_discriminator",
           "export_state", "save_lightning_ckpt"]


def _cpu(sd: StateDict) -> StateDict:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def export_module(module: nn.Module) -> StateDict:
    """A model whose state dict is the reference's as it stands: the
    U-Net encoder with its codebook, the decoder, the VQGAN."""
    return _cpu(module.state_dict())


def export_unet_discriminator(dis: UNetDiscriminator) -> StateDict:
    """The discriminator's state dict plus the reference's unused
    `linear` layer (in features: the last block's channels)."""
    out = _cpu(dis.state_dict())
    in_f = int(d_unet_arch(dis.resolution, dis.D_ch)["out_channels"][-1])
    out_dim = dis.output_dim
    out["linear.weight"] = torch.zeros(out_dim, in_f)
    out["linear.bias"] = torch.zeros(out_dim)
    out["linear.u0"] = torch.ones(1, out_dim)
    out["linear.sv0"] = torch.ones(1)
    return out


def export_nlayer_discriminator(dis: NLayerDiscriminator) -> StateDict:
    """The PatchGAN's state dict with its ActNorms folded (module note)."""
    out = _cpu(dis.state_dict())
    for name, m in dis.named_modules():
        if isinstance(m, ActNorm):
            p = f"{name}."
            out[p + "loc"] = out[p + "loc"] + out.pop(p + "data_loc")
            out[p + "scale"] = out[p + "scale"] * out.pop(p + "data_scale")
    return out


def export_state(state) -> Dict[str, StateDict]:
    """A `TrainState`'s models → {"encoder", "decoder", "discriminator"}
    groups (a VQGAN state: "decoder" and "discriminator"; a state without a
    discriminator has no such group)."""
    named = {}
    if state.encoder is not None:
        named["encoder"] = export_module(state.encoder)
    named["decoder"] = export_module(state.decoder)
    dis = state.discriminator
    if isinstance(dis, UNetDiscriminator):
        named["discriminator"] = export_unet_discriminator(dis)
    elif isinstance(dis, NLayerDiscriminator):
        named["discriminator"] = export_nlayer_discriminator(dis)
    elif dis is not None:
        raise TypeError(f"no export for a discriminator of type {type(dis).__name__}")
    return named


def save_lightning_ckpt(path: str, named: Dict[str, StateDict], epoch: int = 0,
                        step: int = 0) -> str:
    """Write `{'state_dict': {'<name>.<key>': tensor}, 'epoch',
    'global_step'}`, the shape the reference's checkpoint consumers read. No
    optimizer states: a Lightning `resume_from_checkpoint` is out of scope,
    as in the JAX package; a fine-tune starts fresh optimizers."""
    sd = {f"{name}.{k}": v.contiguous() for name, group in named.items()
          for k, v in group.items()}
    torch.save({"state_dict": sd, "epoch": int(epoch), "global_step": int(step)}, path)
    return path
