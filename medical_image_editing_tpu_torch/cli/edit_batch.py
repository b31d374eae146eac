"""Batched codebook-swap editing: painted label maps → decoded slices.

Counterpart of `medical_image_editing_tpu/cli/edit_batch.py`: the
label-0 mask, ids−1, codebook lookup, per-slice mean rescale and decode of
the reference's editing loop (`run_recon.py:182-197`), over a batch of
slices, with the lung re-window, a uint8 output, microbatching and the
int8 decode (`quantize="int8"`, `--dtype int8`: every decoder convolution
through `ops/quantized_conv.py`, on the card its hand-written s8 kernels).
The JAX version's `mesh`/`partition` (multi-chip, ROADMAP item 15) is not
ported yet, so this signature has no such arguments and `main` no
`--partition`.

Painted labels are checked before the codebook lookup (`check_labels`,
from `utils/labels.py`, which the exported program's loader shares): a
label past the codebook raises `ValueError`, where the JAX package's
`jnp.take` fills NaN rows and decodes a NaN image, and where an unchecked
torch index would trip a device assert that leaves the CUDA context
unusable. Negative labels down to 1 − K wrap to the same codebook row on
both sides (both index from the end), so they are accepted.
"""

import argparse
import os

import numpy as np
import torch

from ..models.unet_encoder import get_embed_from_ids
from ..ops.quantized_conv import MODES as QUANTIZE_MODES
from ..ops.quantized_conv import quantize_convs
from ..ops.vq import VQState
from ..ops.windowing import LUNG_WINDOW, denormalize, normalize
from ..utils.device import resolve_device
from ..utils.labels import check_labels


def to_checked_ids(id_maps, dict_size: int, device) -> torch.Tensor:
    """Painted id maps (numpy or tensor) → int32 tensor on `device`, checked
    by `check_labels` where they arrive: on the host for numpy and CPU
    tensors, before the copy to the card."""
    check_labels(id_maps, dict_size)
    return torch.as_tensor(id_maps, device=device).to(torch.int32)


def decode_painted(decoder, vq_state: VQState, id_maps: torch.Tensor, *,
                   is_lung: bool, dataset_window, per_slice: bool = True):
    """id maps (B,H,W), 0 = background → (recon (B,H,W) f32, mask (B,H,W)).

    The labels are checked first (`check_labels`). The embedding is zeroed
    under the mask and rescaled by numel/sum(mask): per slice
    (`per_slice=True`) or over the whole batch, as the single-slice edit
    does. Lung: dataset window → lung window."""
    check_labels(id_maps, vq_state.embed.shape[0])
    return _decode(decoder, vq_state, id_maps, is_lung=is_lung,
                   dataset_window=dataset_window, per_slice=per_slice)


def _decode(decoder, vq_state, id_maps, *, is_lung, dataset_window, per_slice):
    """`decode_painted` on labels already checked."""
    ids = id_maps.to(torch.int32)
    bg = ids == 0
    mask = 1.0 - bg.float()
    embed = get_embed_from_ids(vq_state, torch.where(bg, 1, ids) - 1)
    embed = embed * mask[..., None]
    if per_slice:
        scale = mask[0].numel() / mask.sum((1, 2)).clamp_min(1.0)
        embed = embed * scale[:, None, None, None]
    else:
        embed = embed * (mask.numel() / mask.sum().clamp_min(1.0))
    recon = decoder(embed.permute(0, 3, 1, 2))[:, 0]
    if is_lung:
        recon = normalize(denormalize(recon, *dataset_window), LUNG_WINDOW.width,
                          LUNG_WINDOW.center, LUNG_WINDOW.scale)
    return recon, mask


def load_edited_map(path: str) -> np.ndarray:
    """NIfTI label map → model-space id map (transpose + double flip,
    reference `run_recon.py:90-95`)."""
    from ..utils import nifti

    data = nifti.load(path)
    if data.ndim == 3:
        data = data[:, :, 0]
    return np.transpose(data)[::-1, ::-1].copy()


def make_batched_edit_fn(
    decoder,
    *,
    is_lung: bool = False,
    dataset_window=(4096, 0.0, 2.0),
    output_dtype=None,
    quantize=None,
    microbatch=None,
    device="cuda",
):
    """Moves the decoder to `device` (eval) and returns
    edit(vq_state, id_maps (B,H,W) int) → recon (B,H,W) on `device`.

    output_dtype="uint8" maps [-1,1] → [0,255] with a truncating cast.
    quantize="int8" runs every decoder convolution in int8
    (`ops/quantized_conv.py`: activation scales per input channel over the
    chunk in flight, folded into per-output-channel weight scales); the
    same checkpoint, a serving-time choice.
    microbatch=N decodes the batch N slices at a time; per-slice results
    are unchanged, but the int8 activation scales are taken over each
    chunk, as the JAX package's `lax.scan` takes them."""
    if output_dtype not in (None, "uint8"):
        raise ValueError(f"output_dtype {output_dtype!r}: None or 'uint8'")
    if quantize is not None and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantization mode {quantize!r}")
    dev = resolve_device(device)
    decoder.to(dev).eval()

    def edit_chunk(vq_state, id_maps):
        with quantize_convs(quantize):
            recon, _ = _decode(decoder, vq_state, id_maps, is_lung=is_lung,
                               dataset_window=dataset_window, per_slice=True)
        if output_dtype == "uint8":
            recon = ((recon.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)
        return recon

    @torch.inference_mode()
    def edit(vq_state, id_maps):
        vq_state = VQState(*(t.to(dev) for t in vq_state))
        id_maps = to_checked_ids(id_maps, vq_state.embed.shape[0], dev)
        b = id_maps.shape[0]
        if not microbatch or b <= microbatch:
            return edit_chunk(vq_state, id_maps)
        if b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch {microbatch}")
        return torch.cat([edit_chunk(vq_state, id_maps[i : i + microbatch])
                          for i in range(0, b, microbatch)])

    return edit


def edit_study(
    decoder,
    vq_state: VQState,
    label_dir: str,
    out_dir: str,
    *,
    batch_size: int = 32,
    is_lung: bool = False,
    dataset_window=(4096, 0.0, 2.0),
    quantize=None,
    device="cuda",
):
    """Every `label_*.nii.gz` under label_dir → decoded `edited_*.nii.gz`
    under out_dir, `batch_size` slices per decode (`quantize` as in
    `make_batched_edit_fn`). Returns the names written."""
    from ..utils.nifti import save, to_nifti_array

    files = sorted(
        f for f in os.listdir(label_dir) if f.startswith("label_") and ".nii" in f
    )
    if not files:
        return []
    edit = make_batched_edit_fn(decoder, is_lung=is_lung, dataset_window=dataset_window,
                                quantize=quantize, device=device)
    os.makedirs(out_dir, exist_ok=True)

    written = []
    for start in range(0, len(files), batch_size):
        chunk = files[start : start + batch_size]
        maps = [load_edited_map(os.path.join(label_dir, f)) for f in chunk]
        batch = torch.from_numpy(np.stack(maps).astype(np.int32))
        recons = edit(vq_state, batch).cpu().numpy()
        for f, rec in zip(chunk, recons):
            out = f.replace("label_", "edited_")
            save(to_nifti_array(rec), os.path.join(out_dir, out))
            written.append(out)
    return written


def main(argv=None):
    """CLI: decode every painted `label_*.nii.gz` in a directory, batched."""
    from ..utils.config import load_dotenv
    from ..utils.device import apply_conv_precision
    from .run_recon import CRCConfig, LungConfig, load_model

    apply_conv_precision()
    load_dotenv()  # LUNG_CKPT / CRC_CKPT
    parser = argparse.ArgumentParser(description="Batched codebook-swap editing")
    parser.add_argument("--config", choices=["lung", "crc"], default="lung")
    parser.add_argument("--label-dir", required=True,
                        help="directory of label_*.nii.gz painted id maps")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--dtype", choices=["f32", "bf16", "int8"], default=None,
                        help="decode compute dtype (parameters and checkpoints "
                             "stay f32; int8 runs every decoder convolution on "
                             "the s8 kernels, in f32 around them); default: "
                             "$MEDIMG_EDIT_DTYPE, else f32")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    config = LungConfig() if args.config == "lung" else CRCConfig()
    if args.dtype:
        config.compute_dtype = {"f32": None, "bf16": "bfloat16", "int8": None}[args.dtype]
    _, decoder, vq_state = load_model(config, device=args.device)
    written = edit_study(
        decoder, vq_state, args.label_dir, args.out_dir,
        batch_size=args.batch_size,
        is_lung=config.config_name == "LungConfig",
        dataset_window=(config.window_width, config.window_center,
                        config.window_scale),
        quantize="int8" if args.dtype == "int8" else None,
        device=args.device,
    )
    print(f"{len(written)} edited volumes -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
