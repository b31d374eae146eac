"""Second-stage (adversarial) training step.

Counterpart of `medical_image_editing_tpu/train/second_stage.py` (reference
`src/trainers/single_window_trainer.py:264-539`), the same sequence:
  1. the encoder, frozen in eval mode (no VQ EMA update, no gradient),
     quantizes the batch;
  2. the decoder (train mode: its BatchNorm running stats move; DropBlock
     at `drop_prob` with its `use_dropblock`) renders the reconstruction,
     cast to f32; its loss is recon (MSE, or L1 with `use_l1_loss` and the
     U-Net discriminator) + focal-frequency + perceptual (with
     `use_perceptual_loss` and a `perceptual_fn`) + gen + unet_perceptual:
     gen is −(mean pixel map + mean bottleneck logit)
     of the discriminator on the reconstruction (−mean logits for the
     PatchGAN), unet_perceptual the feature-matching MSEs against the
     discriminator's up-path features of the real image; one Adam step on
     the gradient with respect to the decoder's parameters alone (the
     discriminator's weight gradients are never formed here);
  3. `n_inner_loops` discriminator updates on the *pre-update*
     reconstruction (detached; the reference's one-step-stale input,
     replicated): a forward on the real batch, then the reconstruction,
     hinge losses on map and bottleneck; for the U-Net discriminator a
     CutMix composite (one box per batch, inverted at random), the hinge
     on its map with the (2m − 1) sign and on its bottleneck, and the
     consistency MSE between its map and the maps of real and fake mixed
     by the same box; one Adam step each; the metrics are the last
     iteration's. The PatchGAN path has scalar logits and no CutMix: it
     reports `cutmix` and `consistency` as 0.
Spectral-norm vectors advance once per training-mode forward, in the JAX
step's order: the reconstruction, then the real batch (when
`use_unet_perceptual_loss`), then each iteration's real, fake and CutMix
forwards.

The JAX step is a pure function of (state, image) that splits its PRNG
key; here the step updates the state's modules and optimizers in place
and takes each iteration's CutMix draw (box, invert), then the decode's
DropBlock draws, from the state's generator, or as data.
"""

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.unet_decoder import sample_dropblock_draws
from ..models.unet_encoder import encode_quantize
from ..ops.cutmix import Box, cutmix_coordinates, cutmix_mask, mask_src_tgt
from ..ops.losses import focal_frequency_loss, hinge_d_loss
from ..utils.device import resolve_device
from .first_stage import adam_step
from .state import TrainState

DIS_TYPES = ("UNetDiscriminator", "NLayerDiscriminator")


class SecondStageLossConfig(NamedTuple):
    """Static loss configuration (config section `loss`)."""

    w_recon: float = 1.0
    w_freq: float = 1.0
    w_perceptual: float = 0.0
    w_gen: float = 1.0
    w_unet_perceptual: float = 0.0
    w_dis: float = 1.0
    w_cutmix: float = 1.0
    w_consistency: float = 1.0
    use_recon_loss: bool = True
    use_l1_loss: bool = False
    use_frequency_loss: bool = True
    use_perceptual_loss: bool = False
    use_unet_perceptual_loss: bool = True
    n_inner_loops: int = 1
    dis_loss_type: str = "hinge_d_loss"


def second_stage_config_from_json(loss_cfg) -> SecondStageLossConfig:
    from ..utils.config import getattr_else_none as g

    w = loss_cfg.loss_weight
    return SecondStageLossConfig(
        w_recon=float(g(w, "recon", 1.0) or 0.0),
        w_freq=float(g(w, "freq", 1.0) or 0.0),
        w_perceptual=float(g(w, "perceptual", 0.0) or 0.0),
        w_gen=float(g(w, "gen", 1.0) or 0.0),
        w_unet_perceptual=float(g(w, "unet_perceptual", 0.0) or 0.0),
        w_dis=float(g(w, "dis", 1.0) or 0.0),
        w_cutmix=float(g(w, "cutmix", 1.0) or 0.0),
        w_consistency=float(g(w, "consistency", 1.0) or 0.0),
        use_recon_loss=bool(g(loss_cfg, "use_recon_loss", True)),
        use_l1_loss=bool(g(loss_cfg, "use_l1_loss", False)),
        use_frequency_loss=bool(g(loss_cfg, "use_frequency_loss", True)),
        use_perceptual_loss=bool(g(loss_cfg, "use_perceptual_loss", False)),
        use_unet_perceptual_loss=bool(g(loss_cfg, "use_unet_perceptual_loss", False)),
        n_inner_loops=int(g(loss_cfg, "n_inner_loops", 1) or 1),
        dis_loss_type=str(g(loss_cfg, "dis_loss_type", "hinge_d_loss")),
    )


def unet_perceptual_loss(outputs: Sequence[torch.Tensor],
                         targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-feature MSEs in f32, the targets without gradient."""
    total = torch.zeros((), device=outputs[0].device)
    for o, t in zip(outputs, targets):
        total = total + ((o.float() - t.detach().float()) ** 2).mean()
    return total


def sample_cutmix_draws(generator: torch.Generator, n_inner_loops: int, height: int,
                        width: int) -> List[Tuple[Box, torch.Tensor]]:
    """One (box, invert) per inner iteration, drawn from `generator` on its
    device: the box as `ops.cutmix.cutmix_coordinates` draws it, then
    invert = uniform > 0.5."""
    draws = []
    for _ in range(n_inner_loops):
        box, _ = cutmix_coordinates(generator, height, width)
        invert = torch.rand((), generator=generator, device=generator.device) > 0.5
        draws.append((box, invert))
    return draws


def discriminator_inner_loop(dis, x, recon, draws, cfg: SecondStageLossConfig, opt,
                             is_unet: bool = True):
    """`cfg.n_inner_loops` discriminator updates on the real batch `x` and
    the detached reconstruction `recon` (both NCHW, f32): per iteration the
    real, then the fake forward, hinge losses on map and bottleneck; for
    the U-Net discriminator the CutMix composite of draw i (one box for the
    batch, inverted at random), the hinge on its map with the (2m − 1) sign
    and on its bottleneck, and the consistency MSE between its map and the
    maps of real and fake mixed by the same box; then one Adam step of
    `opt`. The PatchGAN's scalar logits have no CutMix: its `cutmix` and
    `consistency` are 0. Returns the last iteration's (total, {dis,
    cutmix, consistency})."""
    dev = x.device
    h, w = x.shape[-2:]
    zero = torch.zeros((), device=dev)
    for i in range(cfg.n_inner_loops):
        if is_unet:
            r_map, r_bottle, _ = dis(x)
            f_map, f_bottle, _ = dis(recon)
            l_dis = hinge_d_loss(r_map, f_map) + hinge_d_loss(r_bottle, f_bottle)
            box, invert = draws[i]
            # mask = cutmix(ones, zeros, box) = 1 − box, inverted at random
            mask2d = 1.0 - cutmix_mask(box, h, w).to(dev)
            mask2d = torch.where(torch.as_tensor(invert, device=dev), 1.0 - mask2d, mask2d)
            c_map, c_bottle, _ = dis(mask_src_tgt(x, recon, mask2d))
            m = mask2d[None, None]
            l_cutmix = (torch.relu(1.0 + c_bottle).mean()
                        + torch.relu(1.0 - (m * 2.0 - 1.0) * c_map).mean())
            l_consistency = ((c_map - mask_src_tgt(r_map, f_map, mask2d)) ** 2).mean()
            dis_metrics = {"dis": cfg.w_dis * l_dis, "cutmix": cfg.w_cutmix * l_cutmix,
                           "consistency": cfg.w_consistency * l_consistency}
        else:
            l_dis = hinge_d_loss(dis(x), dis(recon))
            dis_metrics = {"dis": cfg.w_dis * l_dis, "cutmix": zero, "consistency": zero}
        dis_total = sum(dis_metrics.values())
        opt.zero_grad()
        dis_total.backward()
        adam_step(opt)
    return dis_total, dis_metrics


def make_second_stage_step(encoder, decoder, dis, *, loss_cfg: SecondStageLossConfig,
                           dis_type: str = "UNetDiscriminator", perceptual_fn=None,
                           device="cuda"):
    """Build the second-stage step.

    encoder: models.unet_encoder.EncoderWithVQ (frozen); decoder:
    models.UNetDecoder; dis: models.UNetDiscriminator or
    models.NLayerDiscriminator (f32); all on `device`, with the decoder's
    and the discriminator's Adams in the `TrainState` the step gets
    (`dec_opt`, `dis_opt`); `perceptual_fn` (pred, target NCHW) → scalar
    (`ops/perceptual.py`). Returns step_fn(state, image (B,H,W,C) in
    [-1,1], draws=None, drop_prob=0.0, dropblock_draws=None) → (state,
    metrics): `draws` holds one (box, invert) per inner iteration
    (`sample_cutmix_draws`; the PatchGAN path draws none),
    `dropblock_draws` the decode's (`sample_dropblock_draws`), drawn from
    `state.generator` in that order by default. Metrics are 0-d tensors on
    the device."""
    if loss_cfg.dis_loss_type != "hinge_d_loss":
        raise ValueError(f"dis_loss_type {loss_cfg.dis_loss_type!r}: the second stage "
                         "trains with 'hinge_d_loss'")
    if dis_type not in DIS_TYPES:
        raise ValueError(f"dis_type {dis_type!r} is not one of {DIS_TYPES}")
    dev = resolve_device(device)
    cfg = loss_cfg
    is_unet = dis_type == "UNetDiscriminator"
    dec_params = list(decoder.parameters())

    def recon_losses(recon, image):
        zero = torch.zeros((), device=dev)
        if not cfg.use_recon_loss:
            l_recon = zero
        elif cfg.use_l1_loss and is_unet:
            l_recon = (recon - image).abs().mean()
        else:
            l_recon = ((recon - image) ** 2).mean()
        l_freq = (focal_frequency_loss(recon.permute(0, 2, 3, 1), image.permute(0, 2, 3, 1))
                  if cfg.use_frequency_loss else zero)
        l_percep = (perceptual_fn(recon, image)
                    if cfg.use_perceptual_loss and perceptual_fn is not None else zero)
        return l_recon, l_freq, l_percep

    def step_fn(state: TrainState, image, draws: Optional[list] = None, drop_prob=0.0,
                dropblock_draws=None):
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        b, h, w, _ = image.shape
        if is_unet and draws is None:
            draws = sample_cutmix_draws(state.generator, cfg.n_inner_loops, h, w)
        if dropblock_draws is None:
            dropblock_draws = sample_dropblock_draws(state.generator, decoder, b, h, w)
        x = image.permute(0, 3, 1, 2)
        zero = torch.zeros((), device=dev)

        # frozen encoder, eval mode: no VQ EMA update, no gradient
        encoder.eval()
        with torch.no_grad():
            q, _, _, _ = encode_quantize(encoder, state.vq, image, momentum=encoder.momentum,
                                         eps=encoder.eps, train=False,
                                         backend=encoder.knn_backend)

        # ---- decoder (generator) update
        decoder.train()
        dis.train()
        recon = decoder(q.permute(0, 3, 1, 2), drop_prob, dropblock_draws).float()
        l_recon, l_freq, l_percep = recon_losses(recon, x)
        l_unet = zero
        if is_unet:
            f_map, f_bottle, f_feats = dis(recon)
            l_gen = -(f_map.mean() + f_bottle.mean())
            if cfg.use_unet_perceptual_loss:
                with torch.no_grad():
                    _, _, r_feats = dis(x)
                l_unet = unet_perceptual_loss(f_feats, r_feats)
        else:
            l_gen = -dis(recon).mean()
        gen_metrics = {
            "recon": cfg.w_recon * l_recon,
            "freq": cfg.w_freq * l_freq,
            "perceptual": cfg.w_perceptual * l_percep,
            "gen": cfg.w_gen * l_gen,
            "unet_perceptual": cfg.w_unet_perceptual * l_unet,
        }
        gen_total = sum(gen_metrics.values())
        grads = torch.autograd.grad(gen_total, dec_params, allow_unused=True)
        # as optax, every parameter takes the Adam update (a zero gradient
        # still moves the moments)
        for p, g in zip(dec_params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.dec_opt.step()
        recon = recon.detach()  # the pre-update reconstruction, as the reference

        dis_total, dis_metrics = discriminator_inner_loop(dis, x, recon, draws, cfg,
                                                          state.dis_opt, is_unet)
        state.step += 1
        metrics = {"gen_total": gen_total, **gen_metrics, "dis_total": dis_total,
                   **dis_metrics, "total": gen_total + dis_total}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn
