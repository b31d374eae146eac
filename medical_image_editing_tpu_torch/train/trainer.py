"""Trainer orchestration: config → models, step, loaders → fit / test loops.

Counterpart of `medical_image_editing_tpu/train/trainer.py` (reference
`src/trainers/base.py`, `src/trainers/single_window_trainer.py`,
`src/run_vqwnet.py::train_model`), in its single-window flavour with
`run.training_mode` "first_step" or "second_step" (train), "inference"
(label-map export) or "test" (metrics), its multi-window flavour
(`use_multi_window`, the CLI's `-w`; reference
`src/trainers/multi_window_trainer.py`) with "first_step", "second_step"
or "joint_step", and its VQGAN flavour (`use_vqgan`, the CLI's `-v`;
reference `src/trainers/vqgan_unet_dis.py`), which trains the VQGAN against
the discriminator in every training mode:
  * the encoder with its codebook and the decoder from
    `config.model.vqmodel`, in its `compute_dtype`; two Adams from
    `enc_optim`/`dec_optim`; the first-stage step from `config.loss` and
    `config.augmentation`;
  * in "second_step" and "joint_step", the discriminator from
    `config.model.dis` (the U-Net discriminator or the PatchGAN, f32; the
    multi-window GAN steps take the U-Net one only) with its Adam from
    `dis_optim`, and the step from `config.loss`; multi-window steps
    (`train/multi_window.py`) weigh each window's terms by
    `loss.recon_weights`/`freq_weights`/`percep_weights`, rematerialise
    the discriminator under `run.use_remat`, and need the dataset's HU
    window (`dataset.window_width/center/scale`);
  * `fit`: codebook k-means on the first batch when the state is fresh
    (`use_init_embed`), full resume (`run.resume_checkpoint`) and mid-epoch
    resume that skips exactly the consumed batches, `max_steps` (a break
    that neither advances the epoch nor saves twice), per-step CSV logging
    and the divergence guard (`run.halt_on_non_finite`, default on) from
    one host copy of the step's metrics, epoch and `save_every_n_steps`
    checkpoints with retention, a train snapshot every SNAPSHOT_INTERVAL
    steps, validation grids on two batches per epoch, and a
    `torch.profiler` Chrome trace of steps [profile_start_step,
    +profile_num_steps) into `run.profile_dir`;
  * staged loading of a first stage (`run.first_stage_ckpt_path`) and of
    a discriminator (`run.discriminator_ckpt_path`): a checkpoint directory
    of this package, or a Lightning `.ckpt` file. The codebook k-means
    runs whenever `use_init_embed` is on and the state is at step 0, as in
    the JAX trainer: a second stage re-clusters the staged codebook;
  * second-stage validation grids show the U-Net discriminator's
    eval-mode maps on image and reconstruction;
  * the VQGAN flavour: `models.VQGAN` from `config.model.vqgan` (f32, its
    EMA momentum the class default 0.99, as the JAX trainer builds it, not
    `vqmodel.momentum`; `vqmodel.knn_backend`) in the state's decoder slot
    with its Adam from `dec_optim`, the discriminator in every mode (the
    JAX trainer always builds it), `train/vqgan_stage.py`'s step, no
    codebook k-means; snapshots, validation, the export and `test` (NMSE,
    SSIM, PSNR and the entropy of ids + 1 → `result.csv`) through the
    whole autoencoder, its ids raw and 0-based;
  * the perceptual loss (`loss.use_perceptual_loss`, for either stage's
    config; `loss.perceptual_loss_type` "vgg" or "lpips",
    `ops/perceptual.py`), built once on the device and handed to every
    step; it is no part of the state, its optimizers or its checkpoints.
    Without pretrained weights (`MEDIMG_VGG19_NPZ` / `MEDIMG_LPIPS_NPZ`) it
    is the seeded random-feature fallback: a warning before the loop and
    `perceptual_fallback` = 1.0 in every logged step, as in JAX;
  * DropBlock (`model.vqmodel.use_dropblock`, `block_size`) on the
    decoder's skips in training, its drop_prob the schedule
    (`start_value`, `stop_value`, `nr_steps`) at the state's epoch;
  * `test`: metrics → `result.csv`; in "inference" mode the per-slice
    PNG/NIfTI export; in the multi-window flavour the HU-denormalized
    per-slice NIfTI export (`evaluate.multi_window_test_export`).

Data parallel (ROADMAP 15(i), 15(ii)), under a process group (`torchrun`,
see `cli/run_vqwnet.py`): the trainer takes its rank and world size from
the group and its device as the rank's card; the encoder, the decoder, the
VQGAN and the PatchGAN are built with `parallel.DATA_AXIS` (synced SPADE
and PatchGAN BatchNorms, ActNorm's data init and the VQ statistics), as
are the steps of every mode (the JAX trainer's `axis_name`,
`trainer.py:123-176,227`), the state (the discriminator and its Adam
included) is replicated from rank 0 after any resume, the k-means gathers
every rank's first batch (a staged codebook's too), every step averages
gradients, the discriminator's buffers and metrics over the ranks (so
every rank takes the same divergence decision), each rank loads
`dataset.batch_size` rows of its shard a step, and validation, snapshots,
checkpoints, the profiler trace and `log.csv` come from rank 0 alone, each
followed by a barrier. `-m test` and the multi-window export run each rank
on its strided shard of the test set and rank 0 writes, as in JAX.

Not ported yet, and refused rather than run without its part: projection
discrimination (`model.dis.n_classes > 0`, item 21).
"""

import math
import os
from typing import Optional

import numpy as np
import torch

from ..data.loader import get_data_loader, prefetch_to_device
from ..models.blocks import seeded_init
from ..models.discriminator import NLayerDiscriminator
from ..models.unet_decoder import UNetDecoder
from ..models.unet_discriminator import UNetDiscriminator, reference_state_dict
from ..models.unet_encoder import EncoderWithVQ
from ..models.vqgan import VQGAN
from ..ops._build import KernelError
from ..ops.dropblock import dropblock_schedule
from ..ops.windowing import denormalize, t_normalize
from ..parallel.mesh import DATA_AXIS, barrier, is_active, rank_device, world
from ..utils.checkpoint import CheckpointManager, restore_fields, restore_state
from ..utils.config import getattr_else_none as g
from ..utils.logging import Logger, is_main_process
from . import evaluate
from .first_stage import init_codebook_step, loss_config_from_json, make_first_stage_step
from .multi_window import (
    make_joint_step,
    make_multi_window_first_stage_step,
    make_multi_window_second_stage_step,
)
from .second_stage import make_second_stage_step, second_stage_config_from_json
from .state import create_train_state, make_optimizer_from_config, replicate_state
from .vqgan_stage import make_vqgan_step

TRAINING_MODES = ("first_step", "second_step")
MULTI_WINDOW_TRAINING_MODES = ("first_step", "second_step", "joint_step")
GAN_MODES = ("second_step", "joint_step")

SNAPSHOT_INTERVAL = 100  # reference `src/trainers/base.py:31`

# errors after which the CUDA context cannot be trusted: snapshots and
# validation, which otherwise never stop training, re-raise them
DEVICE_FAULTS = (KernelError, torch.AcceleratorError)


class TrainingDivergedError(RuntimeError):
    """Raised by `Trainer.fit` when the step's 'total' loss goes non-finite
    and `run.halt_on_non_finite` (default on) is set."""


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP item {item}); "
        "use the JAX package's trainer for it")


class Trainer:
    """Models + step + loaders for one config, on one device (this rank's,
    under a process group)."""

    def __init__(self, config, logger: Optional[Logger] = None, uploader=None,
                 use_multi_window: bool = False, use_vqgan: bool = False,
                 device="cuda", seed: int = 0):
        self.config = config
        self.logger = logger
        self.uploader = uploader
        self.use_multi_window = bool(use_multi_window)
        self.use_vqgan = bool(use_vqgan)
        self.rank, self.world_size = world()
        self.axis_name = DATA_AXIS if is_active() else None
        self.device = rank_device(device)
        self.seed = int(seed)
        self.training_mode = str(config.run.training_mode)
        self._configure_models()
        self._configure_losses()
        self._step = None  # (models, step_fn) of the last state trained
        self._val_loader = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _configure_models(self):
        cfg = self.config
        gen = cfg.model.vqmodel
        if (g(gen, "model_name", None) == "VQGAN") != self.use_vqgan:
            raise ValueError("model.vqmodel.model_name 'VQGAN' and the VQGAN trainer (-v) "
                             "go together")
        self.dict_size = int(gen.dict_size)
        self.eval_dict_size = self.dict_size
        self.compute_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
            str(g(gen, "compute_dtype", "") or ""), None)
        self._enc_kw = dict(
            in_channels=int(gen.in_channels), filters=tuple(gen.enc_filters),
            dict_size=self.dict_size, momentum=float(gen.momentum),
            use_styled_up_block=bool(g(gen, "enc_use_styled_up_block", False)),
            knn_backend=str(g(gen, "knn_backend", "xla") or "xla"), dtype=self.compute_dtype,
            axis_name=self.axis_name)
        self._dec_kw = dict(
            in_channels=int(gen.enc_filters[0]), out_channels=int(gen.in_channels),
            filters=tuple(gen.dec_filters),
            use_dropblock=bool(g(gen, "use_dropblock", False)),
            block_size=int(g(gen, "block_size", 30) or 30),
            dropped_skip_layers=tuple(gen.dropped_skip_layers or ()),
            use_pixel_shuffle=bool(g(gen, "use_pixel_shuffle", True)),
            dtype=self.compute_dtype, axis_name=self.axis_name)
        # DropBlock's schedule (reference `base.py:185-187`)
        self._db = (float(g(gen, "start_value", 0.0) or 0.0),
                    float(g(gen, "stop_value", 0.0) or 0.0),
                    int(g(gen, "nr_steps", 1) or 1))
        if self.use_vqgan:
            v = cfg.model.vqgan
            self.eval_dict_size = int(v.dict_size)
            self._vqgan_kw = dict(
                in_channels=int(v.in_channels), mid_channels=int(v.mid_channels),
                out_channels=int(v.out_channels), emb_dim=int(v.emb_dim),
                dict_size=int(v.dict_size), enc_ch_multiplier=tuple(v.enc_ch_multiplier),
                dec_ch_multiplier=tuple(v.dec_ch_multiplier),
                num_res_blocks=int(v.num_res_blocks),
                enc_attn_resolutions=tuple(v.enc_attn_resolutions or ()),
                dec_attn_resolutions=tuple(v.dec_attn_resolutions or ()),
                resolution=int(v.resolution), p_dropout=float(g(v, "p_dropout", 0.0) or 0.0),
                resamp_with_conv=bool(g(v, "resamp_with_conv", True)),
                knn_backend=str(g(gen, "knn_backend", "xla") or "xla"), axis_name=self.axis_name)
        self._configure_discriminator()

    def _configure_discriminator(self, build: Optional[bool] = None):
        """The discriminator's type and arguments from `config.model.dis`
        (built for the GAN modes and, in every mode, for the VQGAN; `build`
        True or False overrides that, for the checkpoint CLIs)."""
        self.dis_type = self._dis_kw = None
        if build is None:
            build = self.training_mode in GAN_MODES or self.use_vqgan
        if not build:
            return
        dis = self.config.model.dis
        self.dis_type = str(dis.model_name)
        in_ch = int(self.config.model.vqmodel.in_channels)
        if self.dis_type == "UNetDiscriminator":
            if int(g(dis, "n_classes", 0) or 0) > 0:
                raise _not_ported("projection discrimination (model.dis.n_classes > 0)",
                                  "21")
            self._dis_kw = dict(D_ch=int(dis.D_ch), D_wide=bool(g(dis, "D_wide", True)),
                                D_attn=str(g(dis, "D_attn", "0")),
                                resolution=int(dis.resolution), in_channels=in_ch)
        elif self.dis_type == "NLayerDiscriminator":
            self._dis_kw = dict(out_channels=1, n_filters=int(dis.n_filters),
                                n_layers=int(dis.n_layers),
                                normalization=str(dis.normalization),
                                apply_spectral_norm=bool(g(dis, "apply_spectral_norm", False)),
                                in_channels=in_ch, axis_name=self.axis_name)
        else:
            raise ValueError(f"model.dis.model_name {self.dis_type!r} is not "
                             "'UNetDiscriminator' or 'NLayerDiscriminator'")

    def _configure_losses(self):
        cfg = self.config
        self.first_cfg = loss_config_from_json(cfg.loss)
        self.second_cfg = second_stage_config_from_json(cfg.loss)
        self.perceptual_fn = None
        self.perceptual_fallback = False
        if self.first_cfg.use_perceptual_loss or self.second_cfg.use_perceptual_loss:
            from ..ops.perceptual import make_perceptual_loss

            self.perceptual_fn = make_perceptual_loss(
                str(g(cfg.loss, "perceptual_loss_type", "vgg")), device=self.device)
            self.perceptual_fallback = not self.perceptual_fn.pretrained
        if ((self.training_mode in GAN_MODES or self.use_vqgan)
                and self.second_cfg.dis_loss_type != "hinge_d_loss"):
            raise ValueError(f"loss.dis_loss_type {self.second_cfg.dis_loss_type!r}: the "
                             "second stage and the VQGAN train with 'hinge_d_loss'")
        self.aug_cfg = cfg.augmentation
        ds = cfg.dataset
        # None without HU windowing (CRC/BraTS): the lung/mediastinal
        # converters are then unavailable and grids show raw panels
        if g(ds, "window_width", None) is None:
            self.dataset_window = None
        else:
            self.dataset_window = (float(ds.window_width),
                                   float(g(ds, "window_center", 0.0) or 0.0),
                                   float(g(ds, "window_scale", 2.0) or 2.0))
        if self.use_multi_window and self.dataset_window is None:
            raise ValueError("multi-window training computes losses across HU windows; "
                             "set dataset.window_width/window_center/window_scale")

    def _make_step(self, state):
        """The training mode's step on `state`'s models."""
        every = dict(perceptual_fn=self.perceptual_fn, axis_name=self.axis_name)
        if self.use_vqgan:
            return make_vqgan_step(state.decoder, state.discriminator, loss_cfg=self.second_cfg,
                                   w_commit=self.first_cfg.w_commit, device=self.device,
                                   **every)
        dtype = self.compute_dtype or torch.float32
        first = dict(aug_cfg=self.aug_cfg, dict_size=self.dict_size, compute_dtype=dtype,
                     device=self.device, **every)
        if self.use_multi_window:
            loss = self.config.loss
            mw = dict(dataset_window=self.dataset_window,
                      recon_weights=tuple(g(loss, "recon_weights", (1, 1, 1))),
                      freq_weights=tuple(g(loss, "freq_weights", (1, 1, 1))),
                      percep_weights=tuple(g(loss, "percep_weights", (1, 1, 1))))
            use_remat = bool(g(self.config.run, "use_remat", False))
            if self.training_mode == "first_step":
                return make_multi_window_first_stage_step(
                    state.encoder, state.decoder, loss_cfg=self.first_cfg, **first, **mw)
            if self.training_mode == "second_step":
                return make_multi_window_second_stage_step(
                    state.encoder, state.decoder, state.discriminator,
                    loss_cfg=self.second_cfg, use_remat=use_remat, device=self.device,
                    **every, **mw)
            return make_joint_step(
                state.encoder, state.decoder, state.discriminator, first_cfg=self.first_cfg,
                second_cfg=self.second_cfg, use_remat=use_remat, **first, **mw)
        if self.training_mode == "second_step":
            return make_second_stage_step(
                state.encoder, state.decoder, state.discriminator,
                loss_cfg=self.second_cfg, dis_type=self.dis_type, device=self.device, **every)
        return make_first_stage_step(state.encoder, state.decoder, loss_cfg=self.first_cfg,
                                     **first)

    def drop_prob(self, epoch: int) -> float:
        """DropBlock's drop_prob in `epoch` (the schedule; JAX
        `trainer.py:536-538`)."""
        return dropblock_schedule(epoch, *self._db)

    def train_step(self, state, image, draws=None):
        """One step of `state` in the training mode (built once per state's
        models), DropBlock at the drop_prob of the state's epoch."""
        models = (state.encoder, state.decoder, state.discriminator)
        if self._step is None or self._step[0] != models:
            self._step = (models, self._make_step(state))
        return self._step[1](state, image, draws, drop_prob=self.drop_prob(int(state.epoch)))

    # ------------------------------------------------------------------
    # state init + staged loading
    # ------------------------------------------------------------------
    def init_state(self, load_staged: bool = True, with_discriminator: Optional[bool] = None):
        """Fresh models (seeded from `seed`: the encoder and decoder, or the
        VQGAN, as `models.blocks.seeded_init` fills them, then, in the GAN
        modes and for the VQGAN, the discriminator as the JAX module
        initialises) with their Adams and a generator seeded with `seed` on
        the device; then, with `load_staged`, the staged first stage (a
        VQGAN's: the whole autoencoder) and the staged discriminator, if
        configured. `with_discriminator` True or False builds the
        discriminator from `config.model.dis`, or none, whatever the mode
        (the checkpoint CLIs follow the checkpoint). The models take any
        image size, so no init shapes are needed."""
        if with_discriminator is not None and with_discriminator != (self.dis_type is not None):
            self._configure_discriminator(with_discriminator)
        gen = torch.Generator().manual_seed(self.seed)
        if self.use_vqgan:
            encoder = enc_opt = None
            decoder = seeded_init(VQGAN(**self._vqgan_kw), gen).to(self.device)
        else:
            encoder = seeded_init(EncoderWithVQ(**self._enc_kw), gen).to(self.device)
            decoder = seeded_init(UNetDecoder(**self._dec_kw), gen).to(self.device)
            enc_opt = make_optimizer_from_config(encoder.parameters(), self.config.enc_optim)
        dis = dis_opt = None
        if self.dis_type is not None:
            cls = (UNetDiscriminator if self.dis_type == "UNetDiscriminator"
                   else NLayerDiscriminator)
            dis = cls(**self._dis_kw).init_weights(gen).to(self.device)
            dis_opt = make_optimizer_from_config(dis.parameters(), self.config.dis_optim)
        state = create_train_state(
            encoder, decoder, enc_opt,
            make_optimizer_from_config(decoder.parameters(), self.config.dec_optim),
            seed=self.seed, device=self.device, discriminator=dis, dis_opt=dis_opt)
        if not load_staged:
            return state
        run = self.config.run
        path = g(run, "first_stage_ckpt_path", None)
        if path:
            path = str(path)
            if os.path.isfile(path):
                from ..utils.weights import load_lightning_state

                groups = load_lightning_state(path)
                if encoder is not None:
                    encoder.load_state_dict(groups["encoder"], strict=True)
                decoder.load_state_dict(groups["decoder"], strict=True)
                print(f"Imported first stage models from Lightning ckpt {path}")
            else:
                restore_fields(path, state, ("decoder",) if encoder is None
                               else ("encoder", "decoder"))
                print(f"Restored first stage models from {path}")
        path = g(run, "discriminator_ckpt_path", None)
        if path and dis is None:
            print(f"run.discriminator_ckpt_path {path} not loaded: training_mode "
                  f"{self.training_mode!r} has no discriminator")
        elif path:
            path = str(path)
            if os.path.isfile(path):
                from ..utils.weights import load_lightning_state

                sd = load_lightning_state(path)["discriminator"]
                if self.dis_type == "UNetDiscriminator":
                    sd = reference_state_dict(sd)
                dis.load_state_dict(sd, strict=True)
                print(f"Imported the discriminator from Lightning ckpt {path}")
            else:
                restore_fields(path, state, ("discriminator",))
                print(f"Restored the discriminator from {path}")
        return state

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def dataloader(self, mode: str):
        ds = self.config.dataset
        return get_data_loader(
            mode=mode,
            dataset_name=str(ds.dataset_name),
            root_dir_path=str(ds.root_dir_path),
            batch_size=int(ds.batch_size),
            num_workers=int(g(ds, "num_workers", 0) or 0),
            modality=g(ds, "modality", None),
            augmentations=list(g(ds, "augmentations", []) or []) if mode == "train" else None,
            drop_last=(mode == "train"),
            window_width=g(ds, "window_width", None),
            window_center=g(ds, "window_center", None),
            window_scale=g(ds, "window_scale", None),
        )

    def _require_window(self, what: str):
        if self.dataset_window is None:
            raise ValueError(
                f"{what} needs dataset.window_width/window_center/window_scale "
                "in the config (the dataset normalization to invert back to HU)")
        return self.dataset_window

    def to_lung(self, image):
        dw, dc, s = self._require_window("to_lung")
        return t_normalize(denormalize(image, dw, dc, s), 1500, -550, 2.0)

    def to_mediastinal(self, image):
        dw, dc, s = self._require_window("to_mediastinal")
        return t_normalize(denormalize(image, dw, dc, s), 400, 20, 2.0)

    def denormalize_ct_values(self, image):
        dw, dc, s = self._require_window("denormalize_ct_values")
        return denormalize(image, dw, dc, s)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, state=None, max_epochs: Optional[int] = None, max_steps=None):
        cfg = self.config
        run = cfg.run
        modes = MULTI_WINDOW_TRAINING_MODES if self.use_multi_window else TRAINING_MODES
        if not self.use_vqgan and self.training_mode not in modes:
            raise ValueError(
                f"run.training_mode {self.training_mode!r} has no training step here — "
                "the training modes are 'first_step', 'second_step' (and 'joint_step' "
                "with the multi-window trainer); 'inference' and 'test' are test-only "
                "(run with -m test)")
        n_epochs = int(max_epochs if max_epochs is not None else run.n_epochs)
        loader = self.dataloader("train")
        if len(loader) == 0:
            raise ValueError("empty train dataloader: fewer slices than one batch")
        if state is None:
            state = self.init_state()

        saver = None
        if self.logger is not None:
            saver = CheckpointManager(
                os.path.join(self.logger.log_dir, "ckpt"),
                limit_num=int(g(cfg.save, "limit_num", 10) or 10),
                save_interval=int(g(cfg.save, "save_interval", 10) or 10))
        if g(run, "resume_checkpoint", None):
            restore_state(str(run.resume_checkpoint), state)
            print(f"Resumed from {run.resume_checkpoint}")
        if self.axis_name is not None:
            replicate_state(state)

        # codebook k-means on the first batch (reference: in the first
        # forward; under a group, every rank's first batch gathered); the
        # VQGAN's codebook starts random, as in JAX
        if (not self.use_vqgan and bool(g(cfg.model.vqmodel, "use_init_embed", False))
                and state.step == 0):
            first = next(iter(loader))
            init_codebook_step(state.encoder)(state, first["image"])
            print("Initialized codebook with k-means on the first batch")

        eval_forward = self._eval_forward(state)
        # the validation grids show the discriminator's maps in the GAN modes
        dis = state.discriminator if self.training_mode in GAN_MODES else None
        if self.logger is not None and bool(g(run, "use_validation_sanity_check", False)):
            self._on_rank0(self._validate, eval_forward, epoch=-1, dis=dis)
        if self.perceptual_fallback:
            print("WARNING: use_perceptual_loss is ON but no pretrained weights are loaded "
                  "(MEDIMG_VGG19_NPZ / MEDIMG_LPIPS_NPZ unset) — training against the seeded "
                  "random-feature fallback, NOT the reference's learned perceptual metric. "
                  "Metric key 'perceptual_fallback'=1.0 is attached to every step.")

        save_every_n_steps = int(g(cfg.save, "save_every_n_steps", 0) or 0)
        # divergence guard: halt on a non-finite total instead of training
        # on a poisoned state; `run.halt_on_non_finite: false` disables
        halt_on_non_finite = bool(g(run, "halt_on_non_finite", True))
        profile_dir = g(run, "profile_dir", None) if self.rank == 0 else None
        profile_start = int(g(run, "profile_start_step", 10) or 10)
        profile_num = int(g(run, "profile_num_steps", 5) or 5)
        profiler = None
        global_step = int(state.step)
        start_epoch = int(state.epoch)
        # mid-epoch resume: the steps past the completed epochs' batches were
        # consumed before the save; the order is a pure function of (seed,
        # epoch), so skipping that many replays an uninterrupted run's stream
        steps_per_epoch = len(loader)
        resume_skip = max(0, global_step - start_epoch * steps_per_epoch)
        if resume_skip > steps_per_epoch:
            resume_skip = 0  # inconsistent counters; replay the whole epoch
        done = False
        for epoch in range(start_epoch, n_epochs):
            skip = resume_skip if epoch == start_epoch else 0
            batches = loader.epoch_iterator(epoch, skip_batches=skip)
            for batch in prefetch_to_device(batches, size=2, device=self.device):
                if profile_dir and profiler is None and global_step + 1 >= profile_start:
                    profiler = self._start_profiler()
                state, metrics = self.train_step(state, batch["image"])
                global_step += 1
                m = None
                if self.logger is not None or halt_on_non_finite:
                    # one device → host copy for every metric
                    m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
                    if halt_on_non_finite and not math.isfinite(m.get("total", 0.0)):
                        raise TrainingDivergedError(
                            f"non-finite 'total' at step {global_step} (epoch {epoch}); "
                            f"metrics: {m}. The parameter state is poisoned — restart "
                            "from the last checkpoint with a lower LR / different "
                            "seed. Set run.halt_on_non_finite: false to train on "
                            "through NaNs (the reference's behavior).")
                if profiler is not None and global_step >= profile_start + profile_num:
                    self._stop_profiler(profiler, str(profile_dir))
                    profiler, profile_dir = None, None  # one capture per fit
                if self.logger is not None:
                    m["epoch"], m["iteration"] = epoch, global_step
                    if self.perceptual_fallback:
                        m["perceptual_fallback"] = 1.0
                    self.logger.log_metrics(m, step=global_step)
                    if global_step % SNAPSHOT_INTERVAL == 0:
                        self._on_rank0(self._snapshot, eval_forward, batch, global_step)
                saved_step = None
                if saver is not None and save_every_n_steps \
                        and global_step % save_every_n_steps == 0:
                    saver.save(state, epoch, step=global_step)  # step-tagged
                    saved_step = global_step
                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break
            if done:
                # a max_steps break lands mid-epoch: the epoch counter stays
                # (a resume replays the rest of this epoch); save step-tagged
                # unless this step's periodic save wrote that path already
                if saver is not None and saved_step != global_step:
                    saver.save(state, epoch, step=global_step)
                break
            state.epoch += 1
            if saver is not None:
                saver.save(state, epoch)
            if self.logger is not None:
                self._on_rank0(self._validate, eval_forward, epoch, dis=dis)
        if profiler is not None:  # fit ended inside the capture window
            self._stop_profiler(profiler, str(profile_dir))
        return state

    def _on_rank0(self, fn, *args, **kw):
        """`fn` on rank 0 alone; every rank then waits at a barrier."""
        try:
            if self.rank == 0:
                fn(*args, **kw)
        finally:
            barrier()

    def _eval_forward(self, state):
        """image → (recon, label map) of `state`'s models: through the whole
        VQGAN (raw ids) or the encoder and decoder (ids + 1)."""
        if self.use_vqgan:
            return evaluate.make_vqgan_eval_forward(state.decoder, device=self.device)
        return evaluate.make_eval_forward(state.encoder, state.decoder, device=self.device)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profiler(self, profiler, profile_dir: str):
        """Close the capture on finished work; write `trace.json` (Chrome
        trace format) into profile_dir."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    def _snapshot(self, eval_forward, batch, global_step):
        """Rank-0 train snapshot: image / recon / ids grid, optional upload."""
        if not is_main_process():
            return
        from ..utils.imaging import CMAP, as_numpy, save_snapshot_grid

        try:
            recon, ids = eval_forward(batch["image"])
            img = as_numpy(batch["image"])[0, ..., 0]
            rec = as_numpy(recon)[0, ..., 0]
            idm = as_numpy(ids)[0]
            path = os.path.join(self.logger.log_dir, f"train_{str(global_step).zfill(6)}.png")
            os.makedirs(self.logger.log_dir, exist_ok=True)
            save_snapshot_grid(path, [(img, "image", "gray", -1, 1, 1),
                                      (rec, "recon", "gray", -1, 1, 2),
                                      (idm, "ids", CMAP, 0, self.eval_dict_size, 3)],
                               n_row=1, n_col=3)
            print("IDs: ", np.bincount(idm.ravel(), minlength=self.eval_dict_size + 1))
            if self.uploader is not None:
                self.uploader.send_image(path, message=f"Global Step: {global_step}")
        except DEVICE_FAULTS:
            raise
        except Exception as e:  # a snapshot never stops training
            print(f"snapshot failed: {type(e).__name__}: {e}")

    def _dis_maps(self, dis, image, recon):
        """The U-Net discriminator's pixel maps on image and reconstruction
        (B,H,W,1), in eval mode (spectral-norm vectors not stored); the
        module goes back to train mode after."""
        dis.eval()
        try:
            with torch.inference_mode():
                x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
                r_map = dis(x.permute(0, 3, 1, 2))[0]
                f_map = dis(recon.permute(0, 3, 1, 2))[0]
        finally:
            dis.train()
        return r_map.permute(0, 2, 3, 1), f_map.permute(0, 2, 3, 1)

    def _validate(self, eval_forward, epoch, limit_val_batches: int = 2, dis=None):
        """Rank-0 validation grids on the first `limit_val_batches` batches;
        with a U-Net discriminator `dis`, its maps fill the r_map/f_map
        panels."""
        if self._val_loader is None:
            try:
                self._val_loader = self.dataloader("val")
            except (OSError, ValueError) as e:
                print(f"no validation loader: {e}")
                return
        for i, batch in enumerate(self._val_loader):
            if i >= limit_val_batches:
                break
            try:
                dis_maps = outputs = None
                if dis is not None and self.dis_type == "UNetDiscriminator":
                    outputs = eval_forward(batch["image"])
                    dis_maps = self._dis_maps(dis, batch["image"], outputs[0])
                evaluate.validation_snapshot(
                    eval_forward, batch, dis_maps=dis_maps, forward_outputs=outputs,
                    dataset_name=str(self.config.dataset.dataset_name),
                    dict_size=self.eval_dict_size,
                    n_save_images=int(g(self.config.save, "n_save_images", 4) or 4),
                    save_path=os.path.join(self.logger.log_dir, f"val_{epoch:04d}_{i}.png"),
                    to_lung_fn=self.to_lung if self.dataset_window else None,
                    to_mediastinal_fn=self.to_mediastinal if self.dataset_window else None)
            except DEVICE_FAULTS:
                raise
            except Exception as e:  # a grid never stops training
                print(f"validation snapshot failed: {type(e).__name__}: {e}")

    # ------------------------------------------------------------------
    # test / inference
    # ------------------------------------------------------------------
    def test(self, state, save_dir_path: Optional[str] = None):
        """"inference" mode: the per-slice export; the multi-window trainer:
        the HU-denormalized per-slice NIfTI export under `save.save_dir`;
        both return the directories written. Otherwise: (per-batch metric
        dicts, result.csv path); the VQGAN's metrics, as the JAX trainer's,
        without the first slice's PNGs."""
        loader = self.dataloader("test")
        if self.training_mode == "inference" or self.use_multi_window:
            forward = self._eval_forward(state)
            save_root = str(self.config.save.save_dir)
            written = []
            for batch in loader:
                if self.training_mode == "inference":
                    written += evaluate.inference_export(
                        forward, batch, dataset_name=str(self.config.dataset.dataset_name),
                        dict_size=self.eval_dict_size, save_root=save_root,
                        study_name=str(self.config.save.study_name),
                        to_lung_fn=self.to_lung if self.dataset_window else None)
                else:
                    written += evaluate.multi_window_test_export(
                        forward, batch, save_root=save_root,
                        denormalize_fn=self.denormalize_ct_values)
            return written

        if self.use_vqgan:
            fm = evaluate.forward_metrics_fn(self._eval_forward(state), self.eval_dict_size,
                                             id_offset=1)
            outputs = [evaluate.host_metrics(fm(batch["image"])[0]) for batch in loader]
        else:
            fm = evaluate.make_test_metrics_fn(state.encoder, state.decoder, self.dict_size,
                                               device=self.device)
            outputs = []
            for i, batch in enumerate(loader):
                out = evaluate.test_step(fm, batch, i,
                                         dataset_name=str(self.config.dataset.dataset_name),
                                         dict_size=self.dict_size, save_dir_path=save_dir_path)
                if out is not None:
                    outputs.append(out)
        if save_dir_path is None and self.logger is not None:
            save_dir_path = self.logger.log_dir
        return outputs, evaluate.test_epoch_end(outputs, save_dir_path or ".")
