"""Multi-window trainer: every reconstruction loss evaluated on raw,
lung-window and mediastinal-window renderings.

Counterpart of `medical_image_editing_tpu/train/multi_window.py` (reference
`src/trainers/multi_window_trainer.py`):
  * `window_fns`: identity, then lung, then mediastinal — denormalize from
    the dataset window to HU, then the clamp-free `t_normalize` into
    LUNG_WINDOW {1500, −550, 2} / MEDIASTINAL_WINDOW {400, 20, 2}, so
    gradients flow;
  * `make_multiwindow_recon_loss`: (recon, target) → the mean over the
    windows of the weighted MSE, focal-frequency and perceptual terms;
  * `make_multi_window_first_stage_step`: the first-stage step with those
    terms (its `recon_loss_fn` hook);
  * `make_multi_window_second_stage_step`: the encoder frozen, one decoder
    update with per-window recon, freq and generator terms, then one
    discriminator update (no inner loop) with per-window hinge, CutMix and
    consistency terms, one CutMix box and one invert draw per window;
  * `make_joint_step`: encoder, decoder and discriminator in one step — the
    first stage's two views with the per-window terms plus the per-window
    adversarial term on both views, one Adam step each for encoder and
    decoder; then one discriminator update over every window × view pair,
    on the pre-update reconstructions, one box per window shared by the two
    views.
Both GAN steps take the U-Net discriminator only (JAX refuses the PatchGAN,
`multi_window.py:171`).

Spectral-norm vectors advance once per training-mode forward, in the JAX
steps' order, which is part of the observable numerics
(`multi_window.py:431-435,515-518`). Per window, the generator pass runs
the discriminator on the reconstructions (view 1, then view 2), then on
the clear views when `use_unet_perceptual_loss`; the discriminator pass on
the clear views, the reconstructions, then the CutMix composites.

Memory. The discriminator is frozen (`requires_grad` off) during the
generator pass, so torch forms no weight gradients there, as the JAX step
never does. The discriminator pass backpropagates each window's loss as
soon as its forwards are done (`per_window_backward`, default on): a
window's six forwards depend only on the discriminator's parameters and
detached inputs, and the spectral-norm vectors are buffers outside the
gradient, so the summed gradients are those of the summed loss up to f32
summation order, with one window's graphs alive at a time instead of
three. `use_remat` (the config's `run.use_remat`) wraps each
discriminator application in `torch.utils.checkpoint`, whose recompute
starts from the spectral-norm vectors the forward saw (`_checkpointed`);
the decoder is not rematerialised (its BatchNorm stats would move twice).

The JAX steps are pure functions of (state, image) that split their PRNG
key; here the steps update the state's modules and optimizers in place and
take their random draws from the state's generator, or as data: the two
views' augmentation draws (`ops.augment.sample_view_draws`), one (box,
invert) per window (`train.second_stage.sample_cutmix_draws`), then each
decode's DropBlock draws (`models.unet_decoder.sample_dropblock_draws`).
DropBlock's `drop_prob` is an argument of every step.

Data parallel, as the JAX steps' `axis_name` (`multi_window.py:128-144,
251-252, 299-303, 366-367, 500-502, 570-574`): every step built with
`axis_name=parallel.DATA_AXIS` draws from `state.py::per_rank_generator`
(each rank its own views, CutMix boxes and DropBlock masks), averages the
encoder's and the decoder's gradients over the ranks before their Adams
(the VQ statistics and the SPADE BatchNorms sync inside the models, built
with the same `axis_name`), and returns the metrics averaged. The
discriminator's gradients, summed over the windows by the per-window
backward, are averaged once, after the last window, before its Adam; then
its buffers (`second_stage.pmean_buffers`).
"""

import contextlib
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..models.unet_decoder import sample_dropblock_draws
from ..models.unet_encoder import encode_quantize
from ..ops.augment import sample_view_draws
from ..ops.cutmix import cutmix_mask, mask_src_tgt
from ..ops.losses import focal_frequency_loss, hinge_d_loss
from ..ops.windowing import LUNG_WINDOW, MEDIASTINAL_WINDOW, denormalize, t_normalize
from ..utils.device import resolve_device
from .first_stage import (
    FirstStageLossConfig,
    adam_step,
    make_first_stage_forward,
    make_first_stage_step,
    pmean_gradients,
    pmean_metrics,
    step_generator,
    view_dropblock_draws,
)
from .second_stage import (
    SecondStageLossConfig,
    pmean_buffers,
    sample_cutmix_draws,
    unet_perceptual_loss,
)
from .state import TrainState


def window_fns(dataset_window) -> List[Callable]:
    """[identity, to_lung, to_mediastinal]; `dataset_window` is the dataset
    normalization's (width, center, scale)."""
    dw, dc, ds = dataset_window

    def to_window(x, wcfg):
        return t_normalize(denormalize(x, dw, dc, ds), wcfg.width, wcfg.center, wcfg.scale)

    return [lambda x: x,
            lambda x: to_window(x, LUNG_WINDOW),
            lambda x: to_window(x, MEDIASTINAL_WINDOW)]


def make_multiwindow_recon_loss(loss_cfg, dataset_window, recon_weights: Sequence[float],
                                freq_weights: Sequence[float], percep_weights: Sequence[float],
                                perceptual_fn=None):
    """(recon, target) (B,H,W,C) → (l_recon, l_freq, l_percep), each the
    mean over the windows of the per-window weighted term. `loss_cfg` is
    either stage's loss config (its `use_recon_loss`, `use_frequency_loss`,
    `use_perceptual_loss`); `perceptual_fn` (pred, target NCHW) → scalar,
    the perceptual term 0 without it."""
    fns = window_fns(dataset_window)
    n = float(len(fns))
    use_percep = loss_cfg.use_perceptual_loss and perceptual_fn is not None

    def f(recon, target):
        zero = torch.zeros((), device=recon.device)
        l_recon, l_freq, l_percep = zero, zero, zero
        for i, wf in enumerate(fns):
            r, t = wf(recon), wf(target)
            if loss_cfg.use_recon_loss:
                l_recon = l_recon + recon_weights[i] * torch.mean((r - t) ** 2)
            if loss_cfg.use_frequency_loss:
                l_freq = l_freq + freq_weights[i] * focal_frequency_loss(r, t)
            if use_percep:
                l_percep = l_percep + percep_weights[i] * perceptual_fn(_nchw(r), _nchw(t))
        return l_recon / n, l_freq / n, l_percep / n

    return f


def _require_unet(dis):
    # the map + bottleneck protocol (`multi_window_trainer.py:208-392`); a
    # PatchGAN's single logits tensor has neither
    if type(dis).__name__ != "UNetDiscriminator":
        raise ValueError(f"multi-window GAN steps require UNetDiscriminator, got "
                         f"{type(dis).__name__}")


def _sn_buffers(dis) -> List[torch.Tensor]:
    return [b for name, b in dis.named_buffers() if name.endswith(("u0", "sv0"))]


def _checkpointed(dis):
    """dis(x) under `torch.utils.checkpoint` (non-reentrant). A training
    forward advances the spectral-norm vectors in place, so a plain
    recompute would start from the advanced vectors, compute another σ and
    another weight, and advance them again: wrong gradients, and no error.
    Here the recompute starts from the vectors this forward saw, and the
    buffers are put back to what they held before the recompute."""
    buffers = _sn_buffers(dis)

    def apply(x):
        seen = [b.clone() for b in buffers]
        forwarded = []

        def run(x):
            if not forwarded:
                forwarded.append(True)
                return dis(x)
            now = [b.clone() for b in buffers]
            with torch.no_grad():
                for b, s in zip(buffers, seen):
                    b.copy_(s)
            try:
                return dis(x)
            finally:
                with torch.no_grad():
                    for b, s in zip(buffers, now):
                        b.copy_(s)

        return checkpoint(run, x, use_reentrant=False)

    return apply


@contextlib.contextmanager
def frozen(module):
    """The module's parameters without `requires_grad` inside the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def generator_terms(dis, apply_dis, fns, views, use_unet_perceptual: bool):
    """The adversarial terms of the generator pass over `views`, a list of
    (recon, clear) (B,H,W,C) pairs: per window, the discriminator on each
    view's reconstruction, then (with `use_unet_perceptual`) on each clear
    view for the feature targets. Returns (l_gen, l_unet_perceptual), each
    the mean over the windows of the sum over the views."""
    zero = torch.zeros((), device=views[0][0].device)
    l_gen, l_up = zero, zero
    for wf in fns:
        fakes = [apply_dis(_nchw(wf(r))) for r, _ in views]
        for f_map, f_bottle, _ in fakes:
            l_gen = l_gen - (f_map.mean() + f_bottle.mean())
        if use_unet_perceptual:
            for (_, _, f_feats), (_, t) in zip(fakes, views):
                with torch.no_grad():
                    _, _, r_feats = dis(_nchw(wf(t)))
                l_up = l_up + unet_perceptual_loss(f_feats, r_feats)
    n = float(len(fns))
    return l_gen / n, l_up / n


def discriminator_update(dis, apply_dis, fns, views, cut_draws, cfg: SecondStageLossConfig,
                          opt, per_window_backward: bool, axis_name=None):
    """One discriminator update over every window × view pair: per window
    the forwards on the clear views, the (detached) reconstructions, then
    the CutMix composites of each view under the window's box (inverted at
    random); hinge on map and bottleneck, the CutMix hinge, the consistency
    MSE; each window's loss (weighted, over the windows' count)
    backpropagated when its forwards are done, or the summed loss once;
    with `axis_name` the summed gradients averaged over the ranks once,
    then the Adam step, then the buffers averaged (`pmean_buffers`).
    Returns the weighted metrics dis_total, dis, cutmix, consistency."""
    h, w = views[0][0].shape[1:3]
    n = float(len(fns))
    opt.zero_grad()
    sums = torch.zeros(3, device=views[0][0].device)
    deferred = []
    for i, wf in enumerate(fns):
        reals = [_nchw(wf(t)) for _, t in views]
        fakes = [_nchw(wf(r)) for r, _ in views]
        r_out = [apply_dis(x) for x in reals]
        f_out = [apply_dis(x) for x in fakes]
        l_dis = sum(hinge_d_loss(r[0], f[0]) + hinge_d_loss(r[1], f[1])
                    for r, f in zip(r_out, f_out))
        box, invert = cut_draws[i]
        mask2d = 1.0 - cutmix_mask(box, h, w).to(reals[0].device)
        mask2d = torch.where(torch.as_tensor(invert, device=mask2d.device), 1.0 - mask2d, mask2d)
        c_out = [apply_dis(mask_src_tgt(t, r, mask2d)) for t, r in zip(reals, fakes)]
        m = mask2d[None, None]
        l_cutmix = (sum(torch.relu(1.0 + c[1]).mean() for c in c_out)
                    + sum(torch.relu(1.0 - (m * 2.0 - 1.0) * c[0]).mean() for c in c_out))
        l_cons = sum(((c[0] - mask_src_tgt(r[0], f[0], mask2d)) ** 2).mean()
                     for c, r, f in zip(c_out, r_out, f_out))
        terms = torch.stack([cfg.w_dis * l_dis, cfg.w_cutmix * l_cutmix,
                             cfg.w_consistency * l_cons]) / n
        if per_window_backward:
            terms.sum().backward()
        else:
            deferred.append(terms.sum())
        sums = sums + terms.detach()
    if deferred:
        sum(deferred).backward()
    if axis_name is not None:
        pmean_gradients(opt)
    adam_step(opt)
    if axis_name is not None:
        pmean_buffers(dis)
    return {"dis_total": sums.sum(), "dis": sums[0], "cutmix": sums[1], "consistency": sums[2]}


def make_multi_window_first_stage_step(encoder, decoder, *, loss_cfg: FirstStageLossConfig,
                                       aug_cfg, dict_size: int, dataset_window,
                                       recon_weights=(1.0, 1.0, 1.0),
                                       freq_weights=(1.0, 1.0, 1.0),
                                       percep_weights=(1.0, 1.0, 1.0), perceptual_fn=None,
                                       compute_dtype=torch.float32, device="cuda",
                                       axis_name=None):
    """The first-stage step (`first_stage.make_first_stage_step`, data
    parallel with `axis_name`) with the per-window reconstruction terms;
    same signature of the step."""
    recon_loss_fn = make_multiwindow_recon_loss(loss_cfg, dataset_window, recon_weights,
                                                freq_weights, percep_weights, perceptual_fn)
    return make_first_stage_step(encoder, decoder, loss_cfg=loss_cfg, aug_cfg=aug_cfg,
                                 dict_size=dict_size, compute_dtype=compute_dtype,
                                 device=device, recon_loss_fn=recon_loss_fn,
                                 axis_name=axis_name)


def make_multi_window_second_stage_step(encoder, decoder, dis, *,
                                        loss_cfg: SecondStageLossConfig, dataset_window,
                                        recon_weights=(1.0, 1.0, 1.0),
                                        freq_weights=(1.0, 1.0, 1.0),
                                        percep_weights=(1.0, 1.0, 1.0), perceptual_fn=None,
                                        use_remat: bool = False,
                                        per_window_backward: bool = True, device="cuda",
                                        axis_name=None):
    """The GAN step over three windows (U-Net discriminator, hinge). Models
    on `device`; the decoder's and the discriminator's Adams in the
    `TrainState` the step gets. Returns step_fn(state, image (B,H,W,C) in
    [-1,1], draws=None, drop_prob=0.0, dropblock_draws=None) → (state,
    metrics): `draws` is one (box, invert) per window
    (`sample_cutmix_draws(generator, 3, H, W)`), `dropblock_draws` the
    decode's, from `state.generator` in that order by default. Metrics are
    0-d tensors on the device. With `axis_name` the step is data parallel
    (see the module docstring)."""
    if loss_cfg.dis_loss_type != "hinge_d_loss":
        raise ValueError(f"dis_loss_type {loss_cfg.dis_loss_type!r}: the multi-window "
                         "second stage trains with 'hinge_d_loss'")
    _require_unet(dis)
    dev = resolve_device(device)
    cfg = loss_cfg
    fns = window_fns(dataset_window)
    recon_loss = make_multiwindow_recon_loss(cfg, dataset_window, recon_weights, freq_weights,
                                             percep_weights, perceptual_fn)
    apply_dis = _checkpointed(dis) if use_remat else dis

    def step_fn(state: TrainState, image, draws: Optional[list] = None, drop_prob=0.0,
                dropblock_draws=None):
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        b, h, w, _ = image.shape
        if draws is None or (dropblock_draws is None and decoder.use_dropblock):
            gen = step_generator(state.generator, axis_name)
        if draws is None:
            draws = sample_cutmix_draws(gen, len(fns), h, w)
        if dropblock_draws is None:
            dropblock_draws = (sample_dropblock_draws(gen, decoder, b, h, w)
                               if decoder.use_dropblock else None)

        # frozen encoder, eval mode: no VQ EMA update, no gradient
        encoder.eval()
        with torch.no_grad():
            q, _, _, _ = encode_quantize(encoder, state.vq, image, momentum=encoder.momentum,
                                         eps=encoder.eps, train=False,
                                         backend=encoder.knn_backend)

        # ---- decoder (generator) update
        decoder.train()
        dis.train()
        recon = decoder(_nchw(q), drop_prob, dropblock_draws).permute(0, 2, 3, 1).float()
        l_recon, l_freq, l_percep = recon_loss(recon, image)
        with frozen(dis):
            l_gen, l_up = generator_terms(dis, apply_dis, fns, [(recon, image)],
                                           cfg.use_unet_perceptual_loss)
            gen_metrics = {
                "recon": cfg.w_recon * l_recon,
                "freq": cfg.w_freq * l_freq,
                "perceptual": cfg.w_perceptual * l_percep,
                "gen": cfg.w_gen * l_gen,
                "unet_perceptual": cfg.w_unet_perceptual * l_up,
            }
            gen_total = sum(gen_metrics.values())
            state.dec_opt.zero_grad()
            gen_total.backward()
        if axis_name is not None:
            pmean_gradients(state.dec_opt)
        adam_step(state.dec_opt)

        # ---- one discriminator update, on the pre-update reconstruction
        dis_metrics = discriminator_update(dis, apply_dis, fns, [(recon.detach(), image)],
                                            draws, cfg, state.dis_opt, per_window_backward,
                                            axis_name)
        state.step += 1
        metrics = {"gen_total": gen_total, **gen_metrics, **dis_metrics,
                   "total": gen_total + dis_metrics["dis_total"]}
        return state, pmean_metrics({k: v.detach() for k, v in metrics.items()}, axis_name)

    return step_fn


def make_joint_step(encoder, decoder, dis, *, first_cfg: FirstStageLossConfig,
                    second_cfg: SecondStageLossConfig, aug_cfg, dict_size: int, dataset_window,
                    recon_weights=(1.0, 1.0, 1.0), freq_weights=(1.0, 1.0, 1.0),
                    percep_weights=(1.0, 1.0, 1.0), perceptual_fn=None,
                    use_remat: bool = False, per_window_backward: bool = True,
                    compute_dtype=torch.float32, device="cuda", axis_name=None):
    """The joint step: encoder, decoder and U-Net discriminator in one step.
    Models on `device`, their three Adams in the `TrainState` the step gets.
    Returns step_fn(state, image (B,H,W,C) in [-1,1], draws=None,
    drop_prob=0.0, dropblock_draws=None) → (state, metrics): `draws` is
    (view 1's draws, view 2's draws, [one (box, invert) per window]),
    `dropblock_draws` the two decodes' (`view_dropblock_draws`), from
    `state.generator` in that order by default. Metrics are 0-d tensors on
    the device. With `axis_name` (the encoder and decoder built with it
    too) the step is data parallel (see the module docstring)."""
    _require_unet(dis)
    dev = resolve_device(device)
    fns = window_fns(dataset_window)
    recon_loss = make_multiwindow_recon_loss(first_cfg, dataset_window, recon_weights,
                                             freq_weights, percep_weights, perceptual_fn)
    forward = make_first_stage_forward(encoder, decoder, loss_cfg=first_cfg, aug_cfg=aug_cfg,
                                       dict_size=dict_size, compute_dtype=compute_dtype,
                                       device=dev, recon_loss_fn=recon_loss)
    apply_dis = _checkpointed(dis) if use_remat else dis

    def step_fn(state: TrainState, image, draws=None, drop_prob=0.0, dropblock_draws=None):
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        b, h, w, c = image.shape
        if draws is None or (dropblock_draws is None and decoder.use_dropblock):
            gen = step_generator(state.generator, axis_name)
        if draws is None:
            views = [sample_view_draws(gen, aug_cfg, b, h, w, c) for _ in range(2)]
            draws = (*views, sample_cutmix_draws(gen, len(fns), h, w))
        if dropblock_draws is None:
            dropblock_draws = (view_dropblock_draws(gen, decoder, b, h, w)
                               if decoder.use_dropblock else (None, None))
        dis.train()

        # ---- generator pass: the first stage's terms, then the adversarial
        # terms of both views; one Adam step each for encoder and decoder
        metrics, vq_2, recons, clears = forward(state, image, draws[:2], drop_prob,
                                                dropblock_draws)
        views = list(zip(recons, clears))
        with frozen(dis):
            l_gen, l_up = generator_terms(dis, apply_dis, fns, views,
                                           second_cfg.use_unet_perceptual_loss)
            metrics["gen"] = second_cfg.w_gen * l_gen
            metrics["unet_perceptual"] = second_cfg.w_unet_perceptual * l_up
            gen_total = sum(metrics.values())
            for opt in (state.enc_opt, state.dec_opt):
                opt.zero_grad()
            gen_total.backward()
        for opt in (state.enc_opt, state.dec_opt):
            if axis_name is not None:
                pmean_gradients(opt)
            adam_step(opt)
        encoder.vq.set_state(vq_2)

        # ---- one discriminator update, on the pre-update reconstructions
        views = [(r.detach(), t) for r, t in views]
        dis_metrics = discriminator_update(dis, apply_dis, fns, views, draws[2], second_cfg,
                                            state.dis_opt, per_window_backward, axis_name)
        state.step += 1
        out = {"gen_total": gen_total, **metrics, **dis_metrics,
               "total": gen_total + dis_metrics["dis_total"]}
        return state, pmean_metrics({k: v.detach() for k, v in out.items()}, axis_name)

    return step_fn
