"""Batched codebook-swap editing: painted label maps → decoded slices.

Counterpart of `medical_image_editing_tpu/cli/edit_batch.py`: the
label-0 mask, ids−1, codebook lookup, per-slice mean rescale and decode of
the reference's editing loop (`run_recon.py:182-197`), over a batch of
slices, with the lung re-window, a uint8 output, microbatching and the
int8 decode (`quantize="int8"`, `--dtype int8`: every decoder convolution
through `ops/quantized_conv.py`, on the card its hand-written s8 kernels).

Partitions (`mesh=`, a `parallel.mesh.VolumetricMesh`; JAX: a device mesh
with `partition=`), each rank a process under `torchrun`:

* `partition="data"` on a `data × 1` mesh (JAX's `shard_map` over the
  batch): each rank decodes its block of the maps. No collective runs
  inside the decode; under int8 the activation scales are its block's, as
  in JAX's `shard_map`.
* `partition="spatial"` on a `1 × spatial` or `data × spatial` mesh (JAX:
  GSPMD with the maps' rows over 'spatial' and the batch over 'data'): each
  rank decodes its block of rows of its block of maps. What GSPMD inserts
  is written out: every convolution taller than one row takes a row halo
  from its neighbours (1 row, and 2, 6, 12 and 18 in the ASPP head, past
  the neighbour where a block is shorter), the 25 instance norms of the
  lung decoder take the whole map's statistics (two all-reduces each), the
  rescale's mask count is summed over the row (one all-reduce), and under
  int8 each convolution's activation maxima over the whole mesh (one MAX
  all-reduce each: GSPMD's global scales). The packed conv kernel runs on
  the halo'd blocks (`models/blocks.py::Conv`). Each rank's block of rows
  must be divisible by 2^levels.

The edit function then takes and returns this rank's block (`mesh.block`),
and `mesh.gather` joins the blocks; the painted labels are checked on every
rank of the mesh together (`checked_block`), so that all raise or none
does. `edit_study` and `main --partition data|spatial` read every file on
every rank, and rank 0 writes.

Painted labels are checked before the codebook lookup (`check_labels`,
from `utils/labels.py`, which the exported program's loader shares): a
label past the codebook raises `ValueError`, where the JAX package's
`jnp.take` fills NaN rows and decodes a NaN image, and where an unchecked
torch index would trip a device assert that leaves the CUDA context
unusable. Negative labels down to 1 − K wrap to the same codebook row on
both sides (both index from the end), so they are accepted.
"""

import argparse
import contextlib
import os

import numpy as np
import torch

from ..models.unet_encoder import get_embed_from_ids
from ..ops.quantized_conv import MODES as QUANTIZE_MODES
from ..ops.quantized_conv import quantize_convs
from ..ops.vq import VQState
from ..ops.windowing import LUNG_WINDOW, denormalize, normalize
from ..parallel.mesh import VolumetricMesh
from ..utils.device import resolve_device
from ..utils.labels import check_labels


def to_checked_ids(id_maps, dict_size: int, device) -> torch.Tensor:
    """Painted id maps (numpy or tensor) → int32 tensor on `device`, checked
    by `check_labels` where they arrive: on the host for numpy and CPU
    tensors, before the copy to the card."""
    check_labels(id_maps, dict_size)
    return torch.as_tensor(id_maps, device=device).to(torch.int32)


def checked_block(ids, k, mesh, dev, axis="spatial"):
    """`to_checked_ids` of this rank's block (numpy or tensor) → int32 on
    `dev`, the check made on the ranks of the mesh's row (`axis`
    "spatial") or of the whole mesh ("world") together: the blocks' label
    ranges all-reduced first, so that all ranks raise or none does (the
    rank whose block holds the labels names them)."""
    if mesh.world_group is None:
        return to_checked_ids(ids, k, dev)
    ids = torch.as_tensor(ids)
    lo, hi = (int(v) for v in torch.stack(torch.aminmax(ids)).tolist()) if ids.numel() else (1, 1)
    (outside,) = mesh.psum([torch.tensor([max(1 - k - lo, 0), max(hi - k, 0)],
                                         dtype=torch.int64, device=dev)], axis)
    if bool(outside.any()):
        check_labels(ids, k)  # raises where this rank's block holds them
        raise ValueError(f"painted labels outside [{1 - k}, {k}] in another rank's block")
    return ids.to(dev, torch.int32)


def row_mesh(mesh, partition: str):
    """The mesh a decoder shards its rows over for `partition` (None: no
    row sharding, as on a 1 × 1 mesh), after checking that `mesh` fits it:
    "spatial" needs a spatial axis of more than one rank (or a 1 × 1 mesh,
    the unsharded decode), "data" a mesh of one rank on that axis."""
    if partition not in ("data", "spatial"):
        raise ValueError(f"unknown partition {partition!r}")
    if mesh is None:
        return None
    if partition == "spatial":
        if mesh.spatial == 1 and mesh.size > 1:
            raise ValueError(f"partition='spatial' needs a 'spatial' mesh axis of more than "
                             f"one rank; this mesh is data={mesh.data} x spatial=1 "
                             f"(partition='data' splits the batch over it)")
        return mesh if mesh.spatial > 1 else None
    if mesh.spatial > 1:
        raise ValueError(f"partition='data' splits the batch over a data x 1 mesh; this mesh "
                         f"is data={mesh.data} x spatial={mesh.spatial} (partition='spatial' "
                         f"takes it)")
    return None


def check_request(id_maps, dict_size: int, decoder, mesh=None, partition: str = "data"):
    """What every rank of a partitioned service would raise inside the
    decode, checked on rank 0's host before the request goes out, so that
    a bad request is refused (`ValueError`) without reaching the others:
    the painted labels (`check_labels`), and that the decoder's 2^levels
    divides the (B, H, W) maps' width and each rank's rows (H over the
    spatial axis of a row-sharding mesh, else all H)."""
    check_labels(id_maps, dict_size)
    rows = row_mesh(mesh, partition)
    parts = 1 if rows is None else rows.spatial
    h, w, step = int(id_maps.shape[-2]), int(id_maps.shape[-1]), 2**decoder.n_levels
    if h % parts or (h // parts) % step or w % step:
        raise ValueError(f"maps of {h} x {w} over spatial={parts} ranks: each rank's rows "
                         f"and the width must be whole and divisible by 2^{decoder.n_levels} "
                         f"= {step}")


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


def _decode(decoder, vq_state, id_maps, *, is_lung, dataset_window, per_slice, rows=None):
    """`decode_painted` on labels already checked; with a row-sharding mesh
    `rows`, `id_maps` are this rank's rows and the mask count (per slice,
    or of the whole block) is summed over the mesh's row."""
    ids = id_maps.to(torch.int32)
    bg = ids == 0
    mask = 1.0 - bg.float()
    embed = get_embed_from_ids(vq_state, torch.where(bg, 1, ids) - 1)
    embed = embed * mask[..., None]
    if rows is not None:
        counts = mask.sum((1, 2)) if per_slice else mask.sum().reshape(1)
        (counts,) = rows.psum([counts], "spatial")
        numel = mask[0].numel() if per_slice else mask.numel()
        scale = numel * rows.spatial / counts.clamp_min(1.0)
        embed = embed * scale[:, None, None, None]
    elif per_slice:
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
    mesh=None,
    partition: str = "data",
    output_dtype=None,
    quantize=None,
    microbatch=None,
    device="cuda",
):
    """Moves the decoder to `device` (eval) and returns
    edit(vq_state, id_maps (B,H,W) int) → recon (B,H,W) on `device`.

    With a `mesh` (see the module note) `id_maps` and the result are this
    rank's block (`mesh.block`, `mesh.gather`); `partition` "data" or
    "spatial" (ValueError where the mesh does not fit it, `row_mesh`). The
    decoder shards the partition's rows for the length of each call only
    (`UNetDecoder.sharded`).

    output_dtype="uint8" maps [-1,1] → [0,255] with a truncating cast.
    quantize="int8" runs every decoder convolution in int8
    (`ops/quantized_conv.py`: activation scales per input channel over the
    chunk in flight, folded into per-output-channel weight scales); the
    same checkpoint, a serving-time choice.
    microbatch=N decodes the batch N slices at a time; per-slice results
    are unchanged, but the int8 activation scales are taken over each
    chunk, as the JAX package's `lax.scan` takes them (under a mesh: over
    this rank's block; under "spatial" each chunk's over every rank)."""
    if output_dtype not in (None, "uint8"):
        raise ValueError(f"output_dtype {output_dtype!r}: None or 'uint8'")
    if quantize is not None and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantization mode {quantize!r}")
    rows = row_mesh(mesh, partition)
    mesh = mesh or VolumetricMesh(1, 1)
    dev = resolve_device(device)
    decoder.to(dev).eval()

    def edit_chunk(vq_state, id_maps):
        with quantize_convs(quantize):
            recon, _ = _decode(decoder, vq_state, id_maps, is_lung=is_lung,
                               dataset_window=dataset_window, per_slice=True, rows=rows)
        if output_dtype == "uint8":
            recon = ((recon.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)
        return recon

    @torch.inference_mode()
    def edit(vq_state, id_maps):
        vq_state = VQState(*(t.to(dev) for t in vq_state))
        id_maps = checked_block(id_maps, vq_state.embed.shape[0], mesh, dev, "world")
        b = id_maps.shape[0]
        if microbatch and b > microbatch and b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch {microbatch}")
        with decoder.sharded(rows):  # this call's rows only: the module is the caller's
            if not microbatch or b <= microbatch:
                return edit_chunk(vq_state, id_maps)
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
    mesh=None,
    partition: str = "data",
    quantize=None,
    device="cuda",
):
    """Every `label_*.nii.gz` under label_dir → decoded `edited_*.nii.gz`
    under out_dir, `batch_size` slices per decode (`quantize`, `mesh` and
    `partition` as in `make_batched_edit_fn`). Returns the names written.

    Under a mesh every rank reads every file and decodes its block of each
    batch, the tail batch padded up to `batch_size` with copies of its last
    map (dropped after the decode; each rank's block has one shape), the
    blocks are gathered (`mesh.gather`) and rank 0 alone writes."""
    from ..utils.nifti import save, to_nifti_array

    files = sorted(
        f for f in os.listdir(label_dir) if f.startswith("label_") and ".nii" in f
    )
    if not files:
        return []
    edit = make_batched_edit_fn(decoder, is_lung=is_lung, dataset_window=dataset_window,
                                mesh=mesh, partition=partition, quantize=quantize,
                                device=device)
    grid = mesh or VolumetricMesh(1, 1)
    writer = grid.rank == 0
    if writer:
        os.makedirs(out_dir, exist_ok=True)

    written = []
    for start in range(0, len(files), batch_size):
        chunk = files[start : start + batch_size]
        maps = [load_edited_map(os.path.join(label_dir, f)) for f in chunk]
        batch = np.stack(maps).astype(np.int32)
        if mesh is not None and len(chunk) < batch_size:
            batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - len(chunk), 0)])
        recons = grid.gather(edit(vq_state, grid.block(torch.from_numpy(batch))))
        recons = recons.cpu().numpy()[: len(chunk)]
        for f, rec in zip(chunk, recons):
            out = f.replace("label_", "edited_")
            if writer:
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
    parser.add_argument("--partition", choices=["none", "data", "spatial"], default="none",
                        help="shard each decode over every rank of the torchrun group: "
                             "'data' = the batch (throughput), 'spatial' = each map's "
                             "rows with halo-exchanged convolutions (latency)")
    parser.add_argument("--dtype", choices=["f32", "bf16", "int8"], default=None,
                        help="decode compute dtype (parameters and checkpoints "
                             "stay f32; int8 runs every decoder convolution on "
                             "the s8 kernels, in f32 around them); default: "
                             "$MEDIMG_EDIT_DTYPE, else f32")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..parallel.mesh import rank_device, torchrun_mesh

    config = LungConfig() if args.config == "lung" else CRCConfig()
    if args.dtype:
        config.compute_dtype = {"f32": None, "bf16": "bfloat16", "int8": None}[args.dtype]
    if args.partition == "none":
        grid = contextlib.nullcontext(None)
    else:  # every rank on the partition's axis
        grid = torchrun_mesh(*((None, 1) if args.partition == "data" else (1, None)),
                             args.device)
    with grid as mesh:
        device = rank_device(args.device)
        _, decoder, vq_state = load_model(config, device=device)
        written = edit_study(
            decoder, vq_state, args.label_dir, args.out_dir,
            batch_size=args.batch_size,
            is_lung=config.config_name == "LungConfig",
            dataset_window=(config.window_width, config.window_center,
                            config.window_scale),
            mesh=mesh,
            partition="data" if args.partition == "none" else args.partition,
            quantize="int8" if args.dtype == "int8" else None,
            device=device,
        )
        if mesh is None or mesh.rank == 0:
            print(f"{len(written)} edited volumes -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
