"""First-stage (self-supervised) training step.

Counterpart of `medical_image_editing_tpu/train/first_stage.py` (reference
`src/trainers/single_window_trainer.py:68-159`), the same sequence:
  1. denorm the batch to [0,1], two augmented views (noised, clear,
     matrices), renorm to [-1,1];
  2. encode both views through the shared encoder + VQ, the EMA update on
     view 1 then view 2;
  3. warp each view's id map into the other view's frame (one nearest
     resample) and one-hot it without the background channel;
  4. embedding loss (cross, dist, reg) between the quantized embeddings and
     the other view's warped ids;
  5. decode both quantized embeddings (the decoder's BatchNorm running
     stats move on view 1, then view 2; DropBlock, with the decoder's
     `use_dropblock`, at `drop_prob`); MSE, focal-frequency and (with
     `use_perceptual_loss` and a `perceptual_fn`) perceptual
     reconstruction losses against the clear views;
  6. the weighted sum, one backward, one Adam step each for encoder and
     decoder.

The JAX step is a pure function of (state, image) that splits its PRNG key;
here the step updates the state's modules, optimizers and codebook in
place, and takes each view's random draws (`ops/augment.py`), then each
decode's DropBlock draws (`models.unet_decoder.sample_dropblock_draws`),
from the state's generator, or as data.

Data parallel, as the JAX step's `axis_name` (`first_stage.py:105-106,
235-237, 261-262`): a step built with `axis_name=parallel.DATA_AXIS` runs
on each rank's own rows with the encoder and decoder built with the same
`axis_name` (the VQ statistics and the SPADE BatchNorms synced), draws from
`state.py::per_rank_generator` of the replicated generator, averages the
encoder's gradients and then the decoder's over the ranks (one all-reduce
each) before the two Adams, and returns the metrics averaged over the ranks.
`init_codebook_step` of such an encoder gathers every rank's features for
the k-means.
"""

from typing import NamedTuple

import torch

from ..models.unet_decoder import sample_dropblock_draws
from ..models.unet_encoder import encode_quantize, init_codebook_from_batch
from ..ops.augment import cross_view_transform, random_transform, sample_view_draws
from ..ops.losses import embedding_loss, focal_frequency_loss
from ..ops.onehot import one_hot
from ..ops.windowing import denorm, norm
from ..parallel.mesh import pmean, world
from ..utils.device import resolve_device
from .state import TrainState, per_rank_generator


class FirstStageLossConfig(NamedTuple):
    """Static loss configuration (config sections `loss`)."""

    w_commit: float = 1.0
    w_cross: float = 1.0
    w_dist: float = 1.0
    w_reg: float = 1.0
    w_recon: float = 1.0
    w_freq: float = 1.0
    w_perceptual: float = 0.0
    margin: float = 1.0
    use_distance_loss: bool = True
    use_regularization_loss: bool = True
    use_recon_loss: bool = True
    use_frequency_loss: bool = True
    use_perceptual_loss: bool = False


def loss_config_from_json(loss_cfg) -> FirstStageLossConfig:
    from ..utils.config import getattr_else_none as g

    w = loss_cfg.loss_weight
    el = loss_cfg.embed_loss
    return FirstStageLossConfig(
        w_commit=float(g(w, "commit", 1.0) or 0.0),
        w_cross=float(g(w, "cross", 1.0) or 0.0),
        w_dist=float(g(w, "dist", 1.0) or 0.0),
        w_reg=float(g(w, "reg", 1.0) or 0.0),
        w_recon=float(g(w, "recon", 1.0) or 0.0),
        w_freq=float(g(w, "freq", 1.0) or 0.0),
        w_perceptual=float(g(w, "perceptual", 0.0) or 0.0),
        margin=float(g(el, "margin", 1.0) or 0.0),
        use_distance_loss=bool(g(el, "use_distance_loss", True)),
        use_regularization_loss=bool(g(el, "use_regularization_loss", True)),
        use_recon_loss=bool(g(loss_cfg, "use_recon_loss", True)),
        use_frequency_loss=bool(g(loss_cfg, "use_frequency_loss", True)),
        use_perceptual_loss=bool(g(loss_cfg, "use_perceptual_loss", False)),
    )


def adam_step(opt: torch.optim.Optimizer) -> None:
    """One Adam step in which, as in optax, every parameter takes the update:
    a parameter without a gradient steps on a zero one (which still moves
    the moments), where torch would skip it."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def pmean_gradients(opt: torch.optim.Optimizer) -> None:
    """Average the gradients of `opt`'s parameters over the ranks in one
    all-reduce (a missing gradient counts as zero, as in `adam_step`)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for p, g in zip(params, pmean([p.grad for p in params])):
        p.grad = g


def pmean_metrics(metrics: dict, axis_name) -> dict:
    """The metrics averaged over the ranks in one all-reduce (with
    `axis_name`; as given without)."""
    if axis_name is None:
        return metrics
    return dict(zip(metrics, pmean(list(metrics.values()))))


def step_generator(generator: torch.Generator, axis_name) -> torch.Generator:
    """The generator a step draws from: with `axis_name` under more than
    one rank, this rank's `per_rank_generator`; else `generator` itself."""
    rank, size = world()
    if axis_name is None or size == 1:
        return generator
    return per_rank_generator(generator, rank)


def view_dropblock_draws(generator, decoder, batch: int, height: int, width: int):
    """The two decodes' DropBlock draws (None each without `use_dropblock`)."""
    return tuple(sample_dropblock_draws(generator, decoder, batch, height, width)
                 for _ in range(2))


def make_first_stage_forward(encoder, decoder, *, loss_cfg: FirstStageLossConfig, aug_cfg,
                             dict_size: int, compute_dtype=torch.float32, device="cuda",
                             perceptual_fn=None, recon_loss_fn=None):
    """Steps 1-5 of the first-stage step, without the backward: returns
    forward(state, image (B,H,W,C) in [-1,1], draws, drop_prob=0.0,
    dropblock_draws=(None, None)) → (metrics, vq_2, (recon_1, recon_2),
    (clear_1, clear_2)). `metrics` are the weighted terms commit, cross,
    dist, reg, recon, freq and perceptual, still in the graph; the
    reconstructions (f32) and clear views are (B,H,W,C); `draws` is a pair
    of views' draws, `dropblock_draws` the pair of decodes' DropBlock draws.
    `perceptual_fn` (pred, target NCHW) → scalar (`ops/perceptual.py`) is
    applied to each view under `use_perceptual_loss`; without it the term
    is 0, as in JAX. `recon_loss_fn` (recon, clear) → (l_recon, l_freq,
    l_percep), applied to each view and summed, replaces the single-window
    terms (the multi-window trainer's per-window losses, JAX
    `first_stage.py:178-181`)."""
    dev = resolve_device(device)
    cfg = loss_cfg

    def encode(x, vq_state):
        return encode_quantize(encoder, vq_state, x.to(compute_dtype),
                               momentum=encoder.momentum, eps=encoder.eps, train=True,
                               backend=encoder.knn_backend, axis_name=encoder.axis_name)

    def decode(q, drop_prob, dropblock_draws):
        out = decoder(q.permute(0, 3, 1, 2), drop_prob, dropblock_draws)
        return out.permute(0, 2, 3, 1).float()

    def percep(recon, clear):
        return perceptual_fn(recon.permute(0, 3, 1, 2), clear.permute(0, 3, 1, 2))

    def forward(state: TrainState, image, draws, drop_prob=0.0,
                dropblock_draws=(None, None)):
        encoder.train()
        decoder.train()
        with torch.no_grad():
            image01 = denorm(image, 0.0, 1.0)
            noised_1, clear_1, mats_1 = random_transform(image01, aug_cfg, draws[0])
            noised_2, clear_2, mats_2 = random_transform(image01, aug_cfg, draws[1])
            noised_1, noised_2 = norm(noised_1), norm(noised_2)
            clear_1, clear_2 = norm(clear_1), norm(clear_2)

        q1, commit_1, ids_1, vq_1 = encode(noised_1, state.vq)
        q2, commit_2, ids_2, vq_2 = encode(noised_2, vq_1)
        l_commit = commit_1 + commit_2

        with torch.no_grad():
            r_oh_1 = one_hot(cross_view_transform(ids_1, mats_1, mats_2), dict_size + 1)
            r_oh_2 = one_hot(cross_view_transform(ids_2, mats_2, mats_1), dict_size + 1)
        l_cross, l_dist, l_reg = embedding_loss(
            q1, r_oh_1[..., 1:], q2, r_oh_2[..., 1:], vq_2.embed, margin=cfg.margin,
            use_distance_loss=cfg.use_distance_loss,
            use_regularization_loss=cfg.use_regularization_loss,
        )

        # the decoder's BatchNorm running stats move on view 1, then view 2
        recon_1 = decode(q1, drop_prob, dropblock_draws[0])
        recon_2 = decode(q2, drop_prob, dropblock_draws[1])
        zero = torch.zeros((), device=dev)
        if recon_loss_fn is not None:
            lr1, lf1, lp1 = recon_loss_fn(recon_1, clear_1)
            lr2, lf2, lp2 = recon_loss_fn(recon_2, clear_2)
            l_recon, l_freq, l_percep = lr1 + lr2, lf1 + lf2, lp1 + lp2
        else:
            l_recon = (torch.mean((recon_1 - clear_1) ** 2) + torch.mean((recon_2 - clear_2) ** 2)
                       if cfg.use_recon_loss else zero)
            l_freq = (focal_frequency_loss(recon_1, clear_1)
                      + focal_frequency_loss(recon_2, clear_2)
                      if cfg.use_frequency_loss else zero)
            l_percep = (percep(recon_1, clear_1) + percep(recon_2, clear_2)
                        if cfg.use_perceptual_loss and perceptual_fn is not None else zero)

        metrics = {
            "commit": cfg.w_commit * l_commit,
            "cross": cfg.w_cross * l_cross,
            "dist": cfg.w_dist * l_dist,
            "reg": cfg.w_reg * l_reg,
            "recon": cfg.w_recon * l_recon,
            "freq": cfg.w_freq * l_freq,
            "perceptual": cfg.w_perceptual * l_percep,
        }
        return metrics, vq_2, (recon_1, recon_2), (clear_1, clear_2)

    return forward


def make_first_stage_step(encoder, decoder, *, loss_cfg: FirstStageLossConfig, aug_cfg,
                          dict_size: int, compute_dtype=torch.float32, device="cuda",
                          perceptual_fn=None, recon_loss_fn=None, axis_name=None):
    """Build the first-stage step.

    encoder: models.unet_encoder.EncoderWithVQ; decoder: models.UNetDecoder;
    both on `device`, with the optimizers in the `TrainState` the step gets.
    `perceptual_fn` and `recon_loss_fn` as in `make_first_stage_forward`
    (the latter the multi-window trainer's hook). Returns step_fn(state,
    image (B,H,W,C) in [-1,1], draws=None, drop_prob=0.0,
    dropblock_draws=None) → (state, metrics): `draws` is a pair of views'
    draws (`ops.augment.sample_view_draws`), `dropblock_draws` the pair of
    decodes' DropBlock draws (`view_dropblock_draws`); by default the step
    draws them from `state.generator` (`step_generator`), in that order.
    Metrics are 0-d tensors on the device. With `axis_name` (the encoder
    and decoder built with it too) the step is data parallel: this rank's
    rows of the batch in `image`, gradients and metrics averaged over the
    ranks."""
    dev = resolve_device(device)
    forward = make_first_stage_forward(encoder, decoder, loss_cfg=loss_cfg, aug_cfg=aug_cfg,
                                       dict_size=dict_size, compute_dtype=compute_dtype,
                                       device=dev, perceptual_fn=perceptual_fn,
                                       recon_loss_fn=recon_loss_fn)

    def step_fn(state: TrainState, image, draws=None, drop_prob=0.0, dropblock_draws=None):
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        b, h, w, c = image.shape
        if draws is None or (dropblock_draws is None and decoder.use_dropblock):
            gen = step_generator(state.generator, axis_name)
        if draws is None:
            draws = tuple(sample_view_draws(gen, aug_cfg, b, h, w, c) for _ in range(2))
        if dropblock_draws is None:
            dropblock_draws = (view_dropblock_draws(gen, decoder, b, h, w)
                               if decoder.use_dropblock else (None, None))
        metrics, vq_2, _, _ = forward(state, image, draws, drop_prob, dropblock_draws)
        total = sum(metrics.values())

        for opt in (state.enc_opt, state.dec_opt):
            opt.zero_grad()
        total.backward()
        for opt in (state.enc_opt, state.dec_opt):
            if axis_name is not None:
                pmean_gradients(opt)
            adam_step(opt)

        encoder.vq.set_state(vq_2)
        state.step += 1
        metrics = {"total": total.detach(), **{k: v.detach() for k, v in metrics.items()}}
        return state, pmean_metrics(metrics, axis_name)

    return step_fn


def init_codebook_step(encoder, *, num_iters: int = 50):
    """Codebook initialisation, run once before training: k-means on the
    encoder's eval-mode features of one batch (reference: the in-forward
    trigger of `unet_encoder.py:66-91`); for an encoder built with
    `axis_name`, on every rank's batch gathered in rank order (JAX passes
    the same axis to its `init_codebook_step`). Returns init_fn(state,
    image (B,H,W,C), init_idx=None) → state; the K initial rows (of the
    gathered rows) are `init_idx`, or drawn from `state.generator`, the
    ranks' replicated stream."""

    def init_fn(state: TrainState, image, init_idx=None):
        dev = encoder.vq.embed.device
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        training = encoder.training
        encoder.eval()
        with torch.no_grad():
            feats = encoder(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            new_vq = init_codebook_from_batch(feats, encoder.vq.state(),
                                              num_iters=num_iters, init_idx=init_idx,
                                              generator=state.generator,
                                              axis_name=encoder.axis_name)
        encoder.vq.set_state(new_vq)
        encoder.train(training)
        return state

    return init_fn
