"""Training / test CLI of the PyTorch package.

Counterpart of `medical_image_editing_tpu/cli/run_vqwnet.py` (reference
`src/run_vqwnet.py`): `-c` config JSON, `-m train|test`; builds the Logger
(versioned run directory) and the Trainer (single-window, or multi-window
with `-w`), seeds, then fits or tests. `--max-steps` caps a run; `--device` picks the device (default
"cuda": without a card the run is refused, `--device cpu` asks for the
CPU). The Slack image upload is a no-op without `slack_sdk` or the
TOKEN/CHANNEL_ID variables.

    python -m medical_image_editing_tpu_torch.cli.run_vqwnet \
        -c configs/lung_first_stage.json -m train [--max-steps N] [--device cpu]

The second (adversarial) stage is the same command on a config with
`run.training_mode: "second_step"` (configs/lung_second_stage.json), whose
`run.first_stage_ckpt_path` names the first stage's checkpoint directory.

`-w` trains the multi-window trainer (configs/lung_multiwindow_joint.json:
`run.training_mode` "joint_step", "first_step" or "second_step"); its
`-m test` writes HU NIfTI files under `save.save_dir/<patient>/`.

`-v` trains the VQGAN against the U-Net discriminator
(configs/crc_vqgan.json, `model.vqmodel.model_name: "VQGAN"`, the model
from `model.vqgan`); its `-m test` writes NMSE, SSIM, PSNR and the label
entropy to `result.csv`, and `"training_mode": "inference"` exports the
VQGAN's 0-based bottleneck label maps.

Data parallel (ROADMAP 15(i), 15(ii)): under `torchrun` every trainer
trains one replicated model on N ranks, one rank a card, each loading
`dataset.batch_size` rows a step:

    torchrun --nproc-per-node N -m medical_image_editing_tpu_torch.cli.run_vqwnet \
        -c configs/lung_first_stage.json -m train
    torchrun --nproc-per-node N -m medical_image_editing_tpu_torch.cli.run_vqwnet \
        -c configs/lung_second_stage.json -m train
    torchrun --nproc-per-node N -m medical_image_editing_tpu_torch.cli.run_vqwnet \
        -w -c configs/lung_multiwindow_joint.json -m train
    torchrun --nproc-per-node N -m medical_image_editing_tpu_torch.cli.run_vqwnet \
        -v -c configs/crc_vqgan.json -m train

The CLI makes the process group from torchrun's environment (NCCL; gloo
with `--device cpu`) and destroys it at exit; rank 0 alone writes the run
directory (`config.json`, `log.csv`, checkpoints, grids, `result.csv`, the
multi-window export). Without `WORLD_SIZE` in the environment nothing of
this happens.
"""

import argparse
import logging
import os
import random
import warnings

log = logging.getLogger(__name__)


class ImageUploader:
    """Slack uploader (reference `run_vqwnet.py:34-49`): a no-op without
    slack_sdk or the TOKEN/CHANNEL_ID environment variables."""

    def __init__(self):
        self._client = None
        token = os.environ.get("TOKEN")
        self._channel = os.environ.get("CHANNEL_ID")
        if token and self._channel:
            try:
                from slack_sdk import WebClient  # type: ignore

                self._client = WebClient(token=token)
            except ImportError:
                warnings.warn("slack_sdk not installed; Slack upload disabled")

    def send_image(self, file_path, message):
        if self._client is None:
            return
        try:
            self._client.files_upload(channels=self._channel, initial_comment=str(message),
                                      file=file_path)
        except Exception as e:  # an upload never stops a run (reference `:47-49`)
            log.error("Error uploading file: %s", e)


def build_trainer(config, args, seed: int = 0):
    from ..train.trainer import Trainer
    from ..utils.logging import Logger

    uploader = ImageUploader()
    logger = Logger(save_dir=str(config.save.save_dir), config=config,
                    name=str(config.save.study_name),
                    monitoring_metrics=list(config.run.monitoring_metrics or []),
                    uploader=uploader)
    trainer = Trainer(config, logger=logger, uploader=uploader,
                      use_multi_window=bool(args.multiwindow), use_vqgan=bool(args.vqgan),
                      device=args.device, seed=seed)
    return trainer, logger


def main(argv=None):
    from ..utils.device import apply_conv_precision

    apply_conv_precision()
    parser = argparse.ArgumentParser(description="Editable medical image generation")
    parser.add_argument("-c", "--config", help="config", required=True)
    parser.add_argument("-m", "--mode", default="train", choices=["train", "test"])
    parser.add_argument("-w", "--multiwindow", action="store_true",
                        help="multi-window trainer (raw, lung and mediastinal windows)")
    parser.add_argument("-v", "--vqgan", action="store_true",
                        help="VQGAN trainer (the VQGAN against the U-Net discriminator)")
    parser.add_argument("--max-steps", type=int, default=None, help="cap on training steps")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..parallel.mesh import destroy_distributed, initialize_distributed
    from ..utils.device import resolve_device

    resolve_device(args.device)
    created = initialize_distributed(args.device)
    try:
        return _run(args)
    finally:
        if created:
            destroy_distributed()


def _run(args):
    from ..utils.config import getattr_else_none as g
    from ..utils.config import load_dotenv, load_json, validate_config
    from ..utils.seed import init_seed

    load_dotenv()  # TOKEN / CHANNEL_ID etc.
    config = load_json(args.config)
    for w in validate_config(config, multi_window=bool(args.multiwindow),
                             vqgan=bool(args.vqgan)):
        warnings.warn(w)

    seed = g(config.run, "seed", None) or random.randint(1, 10000)
    model_seed, seed_list = init_seed(list(g(config.run, "seed_list", []) or []) or [seed])
    print(f"Seed: {seed}")

    trainer, logger = build_trainer(config, args, seed=model_seed)
    logger.log_hyperparams(seed_list)

    if args.mode == "train":
        trainer.fit(max_steps=args.max_steps)
    else:
        from ..utils.checkpoint import restore_state

        state = trainer.init_state()
        resume = g(config.run, "resume_checkpoint", None)
        if resume:
            restore_state(str(resume), state)
            print(f"Loading model from {resume}")
        trainer.test(state, save_dir_path=logger.log_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
