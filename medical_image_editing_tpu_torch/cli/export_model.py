"""Ahead-of-time export of the serving edit path as one `torch.export` program.

Counterpart of `medical_image_editing_tpu/cli/export_model.py`, with
`torch.export` in place of `jax.export`. The program is the batched edit
function of `cli/edit_batch.py::make_batched_edit_fn`: the label-0 mask,
the codebook lookup, the per-slice mean rescale, the decode, the lung
re-window and an optional uint8 output, with the decoder's weights and the
codebook held in the program. Its batch is symbolic, so one artifact
serves any batch size; its side is fixed at export.

What the export fixes, and where it differs from the JAX artifact:

* The conv route (`MEDIMG_CONV_IMPL`) is read while the program is traced
  and is part of it. Under "packed" each convolution the JAX package routes
  to its Pallas kernel is one node of the operator `medimg::conv3x3_packed`
  (`ops/conv_pack.py`), which launches the hand-written kernel on the card;
  under "xla" every convolution is cuDNN's.
* The f32 precision is not part of the program: cuDNN's f32 convolutions
  and the packed kernel's f32 instance both read cuDNN's TF32 flag when
  they run, so the process that serves the artifact sets it
  (`utils/device.py::apply_conv_precision`, `MEDIMG_CONV_PRECISION`).
* The program runs on the device type it was exported on (constants that
  the decode makes are placed there); `load_edit_artifact` refuses another.
* JAX lowers its artifact for a list of platforms (`--platforms`); a
  `torch.export` program is not lowered per platform, so there is no such
  option.
* The int8 decode is not exported (nor is it by the JAX package).
* The painted labels are checked on the host before the program runs
  (`utils/labels.py::check_labels`, fault C.1): the check depends on the
  data, so it stays outside the graph.

Loading needs torch, this module and `ops/conv_pack.py` (whose import
registers the operator): no model class and no checkpoint.

CLI:
    python -m medical_image_editing_tpu_torch.cli.export_model --config lung \\
        --out edit_lung.pt2 [--image-size 512] [--uint8] [--dtype f32|bf16] \\
        [--allow-random-init] [--device cuda|cpu]
    (checkpoint from LUNG_CKPT/CRC_CKPT, as run_recon)
"""

import argparse
import json
import os
import sys
from typing import NamedTuple

import torch

from ..ops import conv_pack  # noqa: F401  (registers medimg::conv3x3_packed)
from ..utils.device import resolve_device
from ..utils.labels import check_labels

FORMAT = 1
META_FILE = "medimg_edit.json"
EXAMPLE_BATCH = 2  # torch specialises an example batch of 0 or 1


class EditArtifact(NamedTuple):
    """An exported edit program and what its caller needs to know of it."""

    program: torch.export.ExportedProgram
    meta: dict


class _EditProgram(torch.nn.Module):
    """The batched edit function with the codebook as a buffer: id maps
    (B,H,W) int32 → recon (B,H,W)."""

    def __init__(self, decoder, embed, *, is_lung, dataset_window, output_dtype):
        super().__init__()
        self.decoder = decoder
        self.register_buffer("embed", embed)
        self.is_lung = is_lung
        self.dataset_window = tuple(dataset_window)
        self.output_dtype = output_dtype

    def forward(self, id_maps):
        from ..ops.vq import VQState
        from .edit_batch import _decode

        recon, _ = _decode(self.decoder, VQState(self.embed, None, None), id_maps,
                           is_lung=self.is_lung, dataset_window=self.dataset_window,
                           per_slice=True)
        if self.output_dtype == "uint8":
            recon = ((recon.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)
        return recon


def export_edit_artifact(decoder, vq_state, *, image_size: int, is_lung: bool = False,
                         dataset_window=(4096, 0.0, 2.0), output_dtype=None,
                         device="cuda") -> EditArtifact:
    """Trace the batched edit function on `device` → `EditArtifact`.

    The decoder's weights and the codebook are held in the program; its
    input is `(b, image_size, image_size) int32` with `b` symbolic. The
    decoder is moved to `device` in eval mode, as `make_batched_edit_fn`
    moves it."""
    from ..models.blocks import conv_impl
    from ..ops.quantized_conv import quantize_mode

    if output_dtype not in (None, "uint8"):
        raise ValueError(f"output_dtype {output_dtype!r}: None or 'uint8'")
    if quantize_mode() is not None:
        raise ValueError(f"the {quantize_mode()} decode is not exported (neither is the "
                         "JAX package's)")
    dev = resolve_device(device)
    decoder.to(dev).eval()
    embed = vq_state.embed.detach().to(dev).clone()
    program = _EditProgram(decoder, embed, is_lung=is_lung, dataset_window=dataset_window,
                           output_dtype=output_dtype)
    example = torch.zeros((EXAMPLE_BATCH, image_size, image_size), dtype=torch.int32,
                          device=dev)
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        exported = torch.export.export(program, (example,),
                                       dynamic_shapes={"id_maps": {0: batch}})
    dtypes = sorted({str(m.compute_dtype).removeprefix("torch.") for m in decoder.modules()
                     if getattr(m, "compute_dtype", None) is not None}) or ["float32"]
    meta = {"format": FORMAT, "device_type": dev.type, "image_size": int(image_size),
            "dict_size": int(embed.shape[0]), "output_dtype": output_dtype or "float32",
            "is_lung": bool(is_lung), "dataset_window": list(dataset_window),
            "conv_impl": conv_impl(), "compute_dtype": dtypes}
    return EditArtifact(exported, meta)


def save_edit_artifact(path: str, artifact: EditArtifact) -> int:
    """Write the artifact (`torch.export.save`, a .pt2 archive, its meta
    beside the program) → its size in bytes."""
    torch.export.save(artifact.program, path,
                      extra_files={META_FILE: json.dumps(artifact.meta)})
    return os.path.getsize(path)


def load_edit_artifact(path: str, device="cuda"):
    """Load an artifact → call(id_maps (B,H,W) int, numpy or tensor) →
    recon (B,H,W) on `device`.

    `device` must be of the type the artifact was exported on. Needs only
    torch and the operator's registration, no model class and no
    checkpoint. Labels outside [1 − K, K] raise `ValueError` before the
    program runs. `call.program` is the `ExportedProgram`, `call.module`
    the module that runs it, `call.meta` its meta."""
    dev = resolve_device(device)
    extra = {META_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META_FILE])
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: edit artifact format {meta.get('format')}, "
                         f"this loader reads {FORMAT}")
    if meta["device_type"] != dev.type:
        raise ValueError(f"{path} was exported on {meta['device_type']}; load it there, "
                         f"not on {dev}")
    module = exported.module()
    side = meta["image_size"]

    def call(id_maps):
        check_labels(id_maps, meta["dict_size"])
        ids = torch.as_tensor(id_maps, device=dev).to(torch.int32)
        if ids.dim() != 3 or tuple(ids.shape[1:]) != (side, side):
            raise ValueError(f"id maps of shape {tuple(ids.shape)}; the artifact takes "
                             f"(B, {side}, {side})")
        with torch.inference_mode():
            return module(ids)

    call.program, call.module, call.meta = exported, module, meta
    return call


def main(argv=None):
    from ..utils.config import load_dotenv
    from ..utils.device import apply_conv_precision
    from .run_recon import CRCConfig, LungConfig, load_model

    apply_conv_precision()
    load_dotenv()  # LUNG_CKPT / CRC_CKPT, as every sibling serving CLI
    p = argparse.ArgumentParser(description="Export the edit path as a torch.export program")
    p.add_argument("--config", choices=["lung", "crc"], default="lung")
    p.add_argument("--out", required=True)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--uint8", action="store_true",
                   help="quantize [-1,1]→uint8 on device (PNG consumers)")
    p.add_argument("--dtype", choices=["f32", "bf16"], default=None,
                   help="decode compute dtype held in the artifact")
    p.add_argument("--allow-random-init", action="store_true",
                   help="export even with no checkpoint configured (smoke "
                        "tests only: the artifact would serve random weights)")
    p.add_argument("--device", default="cuda",
                   help="device the program is traced on and runs on (cuda, or cpu)")
    args = p.parse_args(argv)

    config = LungConfig() if args.config == "lung" else CRCConfig()
    if args.dtype:
        config.compute_dtype = {"f32": None, "bf16": "bfloat16"}[args.dtype]
    if not config.resume_checkpoint and not args.allow_random_init:
        print("error: no checkpoint configured (set LUNG_CKPT/CRC_CKPT or "
              ".env); pass --allow-random-init to export anyway", file=sys.stderr)
        return 1
    _, decoder, vq_state = load_model(config, device=args.device)
    if not config.resume_checkpoint:
        print("warning: no checkpoint env set: exporting random-init weights",
              file=sys.stderr)
    artifact = export_edit_artifact(
        decoder, vq_state, image_size=args.image_size,
        is_lung=args.config == "lung",
        dataset_window=(config.window_width, config.window_center, config.window_scale),
        output_dtype="uint8" if args.uint8 else None, device=args.device)
    size = save_edit_artifact(args.out, artifact)
    m = artifact.meta
    print(f"wrote {args.out}: {size / 1e6:.1f} MB (batch symbolic, {args.image_size}², "
          f"{m['output_dtype']} output, {'/'.join(m['compute_dtype'])} compute, conv route "
          f"{m['conv_impl']}, {m['device_type']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
