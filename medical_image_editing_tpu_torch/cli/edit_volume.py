"""Volumetric codebook-swap editing: painted 3-D id volumes → decoded volumes.

Counterpart of `medical_image_editing_tpu/cli/edit_volume.py`: the 2-D edit
path's label-0 mask, codebook lookup, mean rescale and decode
(`cli/edit_batch.py`), lifted to the volumetric VQ-WNet with the rescale per
volume. Painted labels are checked first (`cli/edit_batch.py::check_labels`):
a label past the codebook raises `ValueError`; negative labels down to 1 − K
wrap to rows from the end, as in the JAX package.

CLI:
    python -m medical_image_editing_tpu_torch.cli.edit_volume \\
        --ckpt out/volumetric_ckpt --labels labels/ --out edited/ \\
        [--filters 8,16,32,64] [--dict-size 10] [--uint8] [--device cpu]

`--labels` is a directory of `.npy` (D,H,W) or `.nii/.nii.gz` (X,Y,Z) int id
volumes — 0 = background, k = codebook id k−1 — or one such file. Outputs
`edited_<name>` volumes in [-1, 1] (or 0-255 with --uint8), in the format of
each input.

`--ckpt` is the `volumetric_ckpt` directory the port's `train_volumetric`
writes (`state.pt`). The JAX package's Orbax checkpoints cannot be read
here: `tools/volumetric_ckpt.py to-port` converts one (ROADMAP item 22a).
The JAX CLI's `--partition spatial` (decoder depth sharded over cards) is
ROADMAP item 15(iii) and is refused.
"""

import argparse
import os
import sys

import numpy as np
import torch

from ..models.unet_encoder import get_embed_from_ids
from ..ops.vq import VQState
from ..train.volumetric import refuse_mesh
from ..utils.device import resolve_device
from .edit_batch import to_checked_ids

PARTITION_REFUSAL = ("--partition spatial shards the decode's depth over several cards: "
                     "ROADMAP item 15(iii), not ported")


def make_volumetric_edit_fn(decoder, *, mesh=None, output_dtype=None, device="cuda"):
    """Moves the decoder to `device` (eval) and returns
    edit(vq_state, id_vols (B,D,H,W) int) → recon (B,D,H,W) on `device`.

    The labels are checked (`check_labels`), the background (0) masked,
    the embedding looked up at ids − 1, zeroed under the mask and rescaled
    per volume by D·H·W / max(Σmask, 1), then decoded. output_dtype="uint8"
    maps [-1, 1] → [0, 255] with a truncating cast. A `mesh` (depth
    sharding, ROADMAP item 15(iii)) is refused."""
    refuse_mesh(mesh)
    if output_dtype not in (None, "uint8"):
        raise ValueError(f"output_dtype {output_dtype!r}: None or 'uint8'")
    dev = resolve_device(device)
    decoder.to(dev).eval()

    @torch.inference_mode()
    def edit(vq_state, id_vols):
        vq_state = VQState(*(t.to(dev) for t in vq_state))
        ids = to_checked_ids(id_vols, vq_state.embed.shape[0], dev)
        bg = ids == 0
        mask = 1.0 - bg.float()
        embed = get_embed_from_ids(vq_state, torch.where(bg, 1, ids) - 1)
        embed = embed * mask[..., None]
        per_vol = mask[0].numel() / mask.sum((1, 2, 3)).clamp_min(1.0)
        embed = embed * per_vol[:, None, None, None, None]
        recon = decoder(embed.permute(0, 4, 1, 2, 3))[:, 0]
        if output_dtype == "uint8":
            recon = ((recon.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)
        return recon

    return edit


def load_volumetric_checkpoint(path: str, *, filters, dict_size: int, out_channels: int = 1,
                               device="cuda"):
    """Restore a `train_volumetric` checkpoint directory → (decoder on
    `device`, vq_state). `dict_size` must match the codebook."""
    from ..models.volumetric import VolumetricUNetDecoder
    from ..ops.vq import VQModule
    from ..utils.checkpoint import STATE_FILE, load_state_file

    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: not a volumetric checkpoint of the PyTorch "
            "port's train_volumetric. An Orbax checkpoint of the JAX package's "
            "train_volumetric cannot be read here: convert it first with "
            "`python tools/volumetric_ckpt.py to-port --src DIR --out PORT_DIR` (where "
            "orbax is installed; the volumetric part of ROADMAP item 22a)"
        )
    sd = load_state_file(path)
    k, c = sd["vq"]["embed"].shape
    if k != dict_size:
        raise ValueError(f"checkpoint codebook has {k} entries, --dict-size says {dict_size}")
    dev = resolve_device(device)
    codebook = VQModule(k, c)
    codebook.load_state_dict(sd["vq"])
    decoder = VolumetricUNetDecoder(out_channels=out_channels, filters=tuple(filters))
    decoder.load_state_dict(sd["dec"])
    return decoder.to(dev), VQState(*(t.to(dev) for t in codebook.state()))


def _load_label_volume(path: str) -> np.ndarray:
    if ".nii" in os.path.basename(path):
        from ..utils import nifti

        # NIfTI stores (X,Y,Z); editing works depth-major (D,H,W)
        vol = np.transpose(nifti.load(path), (2, 1, 0))
    else:
        vol = np.load(path, allow_pickle=False)
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a (D,H,W) id volume, got {vol.shape}")
    return np.rint(vol).astype(np.int32)


def _save_volume(path: str, vol: np.ndarray) -> None:
    if ".nii" in os.path.basename(path):
        from ..utils import nifti

        nifti.save(np.transpose(vol, (2, 1, 0)).astype(np.float64), path)
    else:
        np.save(path, vol)


def main(argv=None):
    from ..utils.device import apply_conv_precision

    apply_conv_precision()
    p = argparse.ArgumentParser(
        description="Decode painted 3-D id volumes with the volumetric VQ-WNet"
    )
    p.add_argument("--ckpt", required=True,
                   help="train_volumetric checkpoint directory (state.pt)")
    p.add_argument("--labels", required=True,
                   help=".npy/.nii(.gz) id volume, or a directory of them")
    p.add_argument("--out", required=True)
    p.add_argument("--filters", default="8,16,32,64")
    p.add_argument("--dict-size", type=int, default=10)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--partition", choices=["none", "spatial"], default="none",
                   help="'spatial' (multi-card depth sharding, ROADMAP item 15(iii)) is "
                        "refused")
    p.add_argument("--uint8", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.partition == "spatial":
        raise SystemExit(PARTITION_REFUSAL)
    device = resolve_device(args.device)

    filters = tuple(int(f) for f in args.filters.split(","))
    decoder, vq = load_volumetric_checkpoint(args.ckpt, filters=filters,
                                             dict_size=args.dict_size, device=device)
    edit = make_volumetric_edit_fn(decoder, output_dtype="uint8" if args.uint8 else None,
                                   device=device)

    if os.path.isdir(args.labels):
        files = sorted(
            os.path.join(args.labels, f)
            for f in os.listdir(args.labels)
            if f.endswith(".npy") or ".nii" in f
        )
    else:
        files = [args.labels]
    if not files:
        print(f"no .npy/.nii label volumes under {args.labels}", file=sys.stderr)
        return 1

    os.makedirs(args.out, exist_ok=True)
    for start in range(0, len(files), args.batch):
        chunk = files[start : start + args.batch]
        batch = np.stack([_load_label_volume(f) for f in chunk])
        pad = args.batch - len(chunk)
        if pad:  # a full batch: repeat the last volume, trim after
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])
        recons = edit(vq, batch).cpu().numpy()[: len(chunk)]
        for f, rec in zip(chunk, recons):
            name = "edited_" + os.path.basename(f)
            _save_volume(os.path.join(args.out, name), rec)
            print(name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
