"""`export_ckpt`: a checkpoint of the port → a reference-compatible
Lightning `.ckpt`.

Counterpart of `medical_image_editing_tpu/cli/export_ckpt.py`, the inverse
of `import_ckpt`: train on the card, then hand the `.ckpt` to the reference
(its modules load the `state_dict` with `load_state_dict(strict=True)`), to
the JAX package (`import-ckpt`, or `LUNG_CKPT` at the file), or back to the
port. The models come from the same config JSON; the checkpoint's
`discriminator`, where it has one, is exported whatever
`run.training_mode` says. No optimizer states are exported, as in the JAX
package.

Usage:
    python -m medical_image_editing_tpu_torch.cli.export_ckpt \\
        -c config.json --ckpt results/study/version_0/ckpt --out ref.ckpt [--device cpu]
"""

import argparse
import warnings


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a checkpoint of the port as a reference Lightning .ckpt")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="the port's checkpoint directory (a run's ckpt/ or one "
                             "ckpt-epoch=... directory)")
    parser.add_argument("--out", required=True, help="output .ckpt path")
    parser.add_argument("-w", "--multiwindow", action="store_true")
    parser.add_argument("-v", "--vqgan", action="store_true")
    parser.add_argument("--epoch", type=int, default=None,
                        help="pick a specific saved epoch (default: newest)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="accepted for the JAX CLI's sake; the port's models "
                             "take any size, so it changes nothing")
    parser.add_argument("--device", default="cuda",
                        help="device the models are built on (default cuda; "
                             "without a card pass --device cpu)")
    args = parser.parse_args(argv)

    from ..train.trainer import Trainer
    from ..utils import torch_export as te
    from ..utils.checkpoint import load_state_file, resolve
    from ..utils.config import load_json, validate_config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu: refused here
    config = load_json(args.config)
    for w in validate_config(config, multi_window=bool(args.multiwindow),
                             vqgan=bool(args.vqgan)):
        warnings.warn(w)
    trainer = Trainer(config, use_multi_window=bool(args.multiwindow),
                      use_vqgan=bool(args.vqgan), device=device)
    saved = load_state_file(resolve(args.ckpt, args.epoch), trainer.device)
    state = trainer.init_state(load_staged=False,
                               with_discriminator="discriminator" in saved)
    state.load_state_dict(saved)
    named = te.export_state(state)
    te.save_lightning_ckpt(args.out, named, epoch=state.epoch, step=state.step)
    print(f"Exported (epoch {state.epoch}, step {state.step}): {', '.join(named)}")
    print(f"Wrote reference-compatible Lightning checkpoint: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
