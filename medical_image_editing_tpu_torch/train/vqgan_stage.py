"""VQGAN adversarial training step (the VQGAN autoencoder against the U-Net
discriminator).

Counterpart of `medical_image_editing_tpu/train/vqgan_stage.py` (reference
`src/trainers/vqgan_unet_dis.py:36-185`, `VQGAN_UNetDis_Trainer.
training_step`). The generator is the whole VQGAN, kept in the state's
decoder slot with its Adam in `dec_opt` (the reference trainer's `decoder`
field, `src/trainers/base.py:204-222`); its codebook is live. The sequence:
  1. the VQGAN forward in train mode (the codebook's EMA moves; dropout
     masks, if `p_dropout` > 0, from the state's generator);
  2. recon MSE, focal-frequency and (with `use_perceptual_loss` and a
     `perceptual_fn`) perceptual loss on the reconstruction (f32);
  3. the discriminator (train mode) on the reconstruction: gen is
     −(mean pixel map + mean bottleneck logit); with
     `use_unet_perceptual_loss` it runs on the image too (train mode, no
     graph) for the feature-matching targets;
  4. total = w_recon·recon + w_freq·freq + w_perceptual·perceptual + w_commit·commit
     + w_gen·gen + w_unet_perceptual·unet_perceptual, one Adam step on the
     VQGAN's parameters (every one of them, as optax);
  5. `n_inner_loops` discriminator updates on the pre-update
     reconstruction, detached (`second_stage.discriminator_inner_loop`:
     real, fake and CutMix forwards, hinge + CutMix + consistency, one Adam
     step each); the metrics are the last iteration's.
Spectral-norm vectors advance once per train-mode forward in that order.

The discriminator is frozen (`requires_grad` off) during the generator
pass, so torch forms no weight gradients there (the JAX step never does),
and the generator pass's graph is freed before the inner loop: at 512²,
batch 8 the VQGAN's graph and one discriminator graph, then three
discriminator graphs, are alive at a time. The CutMix (box, invert) draws
come from the state's generator or as data (`sample_cutmix_draws`). The
VQGAN has no DropBlock: the step takes `drop_prob` and ignores it, as the
JAX step does.

Data parallel, as the JAX step's `axis_name` (`vqgan_stage.py:55,
133-134, 178-179, 188-191, 195-196`): a step built with
`axis_name=parallel.DATA_AXIS` runs on each rank's own rows with the VQGAN
built with the same `axis_name` (its codebook's counts and sums averaged
before the EMA), draws its CutMix boxes and dropout masks from
`state.py::per_rank_generator`, averages the VQGAN's gradients before its
Adam, runs the second stage's inner loop with its averages
(`second_stage.discriminator_inner_loop`), and returns the metrics
averaged over the ranks.
"""

from typing import Optional

import torch

from ..ops.losses import focal_frequency_loss
from ..utils.device import resolve_device
from .first_stage import pmean_gradients, pmean_metrics, step_generator
from .multi_window import _require_unet, frozen
from .second_stage import (
    SecondStageLossConfig,
    discriminator_inner_loop,
    sample_cutmix_draws,
    unet_perceptual_loss,
)
from .state import TrainState


def make_vqgan_step(vqgan, dis, *, loss_cfg: SecondStageLossConfig, w_commit: float = 1.0,
                    perceptual_fn=None, device="cuda", axis_name=None):
    """Build the VQGAN step. vqgan: models.VQGAN; dis: models.
    UNetDiscriminator (f32); both on `device`, their Adams in the
    `TrainState` (`dec_opt`, `dis_opt`); `perceptual_fn` (pred, target
    NCHW) → scalar (`ops/perceptual.py`). Returns step_fn(state, image
    (B,H,W,C) in [-1,1], draws=None, drop_prob=0.0) → (state, metrics):
    `draws` holds one (box, invert) per inner iteration, drawn from
    `state.generator` (`step_generator`) by default, then the dropout
    masks. Metrics are 0-d tensors on the device. With `axis_name` the step
    is data parallel (see the module docstring)."""
    if loss_cfg.dis_loss_type != "hinge_d_loss":
        raise ValueError(f"dis_loss_type {loss_cfg.dis_loss_type!r}: the VQGAN trains with "
                         "'hinge_d_loss'")
    _require_unet(dis)
    dev = resolve_device(device)
    cfg = loss_cfg
    params = list(vqgan.parameters())

    def step_fn(state: TrainState, image, draws: Optional[list] = None, drop_prob=0.0):
        del drop_prob  # no DropBlock in the VQGAN
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        _, h, w, _ = image.shape
        gen = state.generator
        if draws is None or vqgan.p_dropout > 0:
            gen = step_generator(state.generator, axis_name)
        if draws is None:
            draws = sample_cutmix_draws(gen, cfg.n_inner_loops, h, w)
        x = image.permute(0, 3, 1, 2)
        zero = torch.zeros((), device=dev)

        # ---- the VQGAN (generator) update
        vqgan.train()
        dis.train()
        recon, commit, _, _ = vqgan(x, train=True, generator=gen)
        recon = recon.float()
        l_recon = ((recon - x) ** 2).mean() if cfg.use_recon_loss else zero
        l_freq = (focal_frequency_loss(recon.permute(0, 2, 3, 1), image)
                  if cfg.use_frequency_loss else zero)
        l_percep = (perceptual_fn(recon, x)
                    if cfg.use_perceptual_loss and perceptual_fn is not None else zero)
        l_unet = zero
        with frozen(dis):
            f_map, f_bottle, f_feats = dis(recon)
            l_gen = -(f_map.mean() + f_bottle.mean())
            if cfg.use_unet_perceptual_loss:
                with torch.no_grad():
                    _, _, r_feats = dis(x)
                l_unet = unet_perceptual_loss(f_feats, r_feats)
        gen_metrics = {
            "recon": cfg.w_recon * l_recon,
            "freq": cfg.w_freq * l_freq,
            "perceptual": cfg.w_perceptual * l_percep,
            "commit": w_commit * commit,
            "gen": cfg.w_gen * l_gen,
            "unet_perceptual": cfg.w_unet_perceptual * l_unet,
        }
        gen_total = sum(gen_metrics.values())
        grads = torch.autograd.grad(gen_total, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        del grads, f_map, f_bottle, f_feats
        if axis_name is not None:
            pmean_gradients(state.dec_opt)
        state.dec_opt.step()
        recon = recon.detach()  # the pre-update reconstruction, as the reference
        gen_metrics = {k: v.detach() for k, v in gen_metrics.items()}
        gen_total = gen_total.detach()

        # ---- discriminator inner loop
        dis_total, dis_metrics = discriminator_inner_loop(dis, x, recon, draws, cfg,
                                                          state.dis_opt, axis_name=axis_name)
        state.step += 1
        metrics = {"gen_total": gen_total, **gen_metrics, "dis_total": dis_total,
                   **dis_metrics, "total": gen_total + dis_total}
        return state, pmean_metrics({k: v.detach() for k, v in metrics.items()}, axis_name)

    return step_fn
