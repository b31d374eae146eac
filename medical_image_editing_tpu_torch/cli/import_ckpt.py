"""`import_ckpt`: a reference-format Lightning `.ckpt` → a checkpoint
directory of the port.

Counterpart of `medical_image_editing_tpu/cli/import_ckpt.py`. The file's
`state_dict` nests each model under its trainer attribute (`encoder.*`,
`decoder.*`, `discriminator.*`): a file of the reference, or one written by
the JAX package's `export-ckpt` (the way across for its Orbax directories,
which the card's machine cannot read) or by the port's `export_ckpt`. This
CLI builds the models from the same config JSON the trainer uses, loads the
file's models strictly (`utils/torch_import.py`: the codebook buffers, the
SPADE BatchNorm statistics, the spectral-norm vectors and ActNorms), keeps
its epoch and step, and writes `--out/ckpt-epoch=EEEE/state.pt` with
`utils/checkpoint.py::CheckpointManager`. The result is usable as
`run.resume_checkpoint`, `run.first_stage_ckpt_path`,
`run.discriminator_ckpt_path` and `LUNG_CKPT` / `CRC_CKPT` (`run_recon`,
`edit_batch`, `serve_http`).

Usage:
    python -m medical_image_editing_tpu_torch.cli.import_ckpt \\
        -c configs/lung_first_stage.json --ckpt last.ckpt --out converted/ [--device cpu]
    LUNG_CKPT=converted python -m medical_image_editing_tpu_torch.cli.edit_batch ...

The optimizers start fresh, as the JAX import starts them: torch Adam
moments of another run do not map onto these modules' optimizer states in
storage, and a resumed fine-tune re-warms them in a few steps. A file with
a discriminator gets one in the state whatever `run.training_mode` says
(the JAX trainer builds it in every mode); one without gets none.
"""

import argparse
import warnings


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a reference Lightning .ckpt to a checkpoint of the port")
    parser.add_argument("-c", "--config", required=True,
                        help="the reference-style config JSON for this model")
    parser.add_argument("--ckpt", required=True, help="Lightning .ckpt path")
    parser.add_argument("--out", required=True, help="output checkpoint directory")
    parser.add_argument("-w", "--multiwindow", action="store_true")
    parser.add_argument("-v", "--vqgan", action="store_true",
                        help="the checkpoint's decoder field holds a VQGAN")
    parser.add_argument("--image-size", type=int, default=None,
                        help="accepted for the JAX CLI's sake; the port's models "
                             "take any size, so it changes nothing")
    parser.add_argument("--device", default="cuda",
                        help="device the models are built on (default cuda; "
                             "without a card pass --device cpu)")
    args = parser.parse_args(argv)

    from ..train.trainer import Trainer
    from ..utils import torch_import as ti
    from ..utils.checkpoint import CheckpointManager
    from ..utils.config import load_json, validate_config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu: refused here
    config = load_json(args.config)
    for w in validate_config(config, multi_window=bool(args.multiwindow),
                             vqgan=bool(args.vqgan)):
        warnings.warn(w)
    groups, meta = ti.load_reference_ckpt(args.ckpt)
    if not any(g in groups for g in ti.GROUPS):
        raise SystemExit("no encoder./decoder./discriminator. keys found in "
                         f"{args.ckpt} — is this a reference checkpoint?")
    if "decoder" in groups and ti.is_vqgan_group(groups["decoder"]) != bool(args.vqgan):
        raise SystemExit(f"{args.ckpt}: its decoder field "
                         f"{'holds' if not args.vqgan else 'does not hold'} a VQGAN; "
                         f"{'pass' if not args.vqgan else 'drop'} -v")

    trainer = Trainer(config, use_multi_window=bool(args.multiwindow),
                      use_vqgan=bool(args.vqgan), device=device)
    state = trainer.init_state(load_staged=False,
                               with_discriminator="discriminator" in groups)
    imported = []
    if "encoder" in groups:
        if state.encoder is None:
            raise SystemExit(f"{args.ckpt}: an encoder field beside a VQGAN decoder")
        ti.import_module(state.encoder, groups["encoder"], "UNetEncoder")
        imported.append("UNetEncoder + VQ buffers")
    if "decoder" in groups:
        what = "VQGAN (decoder field) + VQ buffers" if args.vqgan else "UNetDecoder"
        ti.import_module(state.decoder, groups["decoder"], what.split(" ")[0])
        imported.append(what + ("" if args.vqgan else " (incl. SPADE BN running stats)"))
    if "discriminator" in groups:
        ti.import_module(state.discriminator, groups["discriminator"], trainer.dis_type)
        imported.append(f"{trainer.dis_type} (spectral-norm vectors kept)")

    state.step, state.epoch = meta["step"], meta["epoch"]
    CheckpointManager(args.out, limit_num=10**9).save(state, epoch=meta["epoch"])
    print(f"Imported from {args.ckpt} (epoch {meta['epoch']}, step {meta['step']}):")
    for line in imported:
        print(f"  * {line}")
    print(f"Wrote a checkpoint of the port under {args.out}: usable as "
          "resume_checkpoint / first_stage_ckpt_path / discriminator_ckpt_path / "
          "LUNG_CKPT.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
