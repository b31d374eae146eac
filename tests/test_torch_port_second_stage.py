"""The second-stage training step, port vs JAX package, on the CPU at small
size: `make_second_stage_step` with the U-Net discriminator (`D_ch` 4,
resolution 128, no attention) and with the PatchGAN (batch norm and
spectral norm), one and two inner loops, on the lung config's losses and
optimizers; encoder and decoder filters (4, 8, 16, 32, 64), batch 2,
64² images (the 128 architecture is fully convolutional up to its
sum-pooled bottleneck), `knn_backend: "pallas"` and
`MEDIMG_CONV_IMPL=packed` (the JAX side runs its Pallas kernels in
interpret mode), float32.

Both sides start from the same flax-initialised variables (through
`utils/weights.py::from_jax_train_state`) and use the same CutMix draws:
the test replays the JAX step's key splits (`second_stage.py:148,240-246,
292`, `ops/cutmix.py:20-24`) into the port's draws. The JAX step is
compiled once per case and conv route (module fixture).

Tolerances, float32 (readings of the four cases on this suite's CPU
host in brackets):
* losses: rtol 1e-4 (atol 1e-6 for the small consistency term) where
  they are computed before any update (every loss with one inner loop,
  the generator's with two), as the first-stage step test; the second
  iteration's discriminator losses, after one Adam step of the
  discriminator, within 5× the JAX step's own route floor or rtol 1e-4,
  whichever is wider [all ≤ 1.2e-6].
* the gradients, read from Adam's first moment ((1 − β1)·g after one
  step), relative Frobenius norm over all parameters of decoder and
  discriminator: within 5× the JAX step's own route floor (its `packed`
  and `xla` conv routes compute the same function and differ only in the
  summation order of the routed convolutions) or 1e-4, whichever is wider
  [decoder 1.5e-5 and 1.8e-5 against floors 1.2e-5 and 1.4e-5;
  discriminator 1.5e-6 to 3.0e-5].
* one-step parameter deltas: Adam's first step is ±lr·g/(|g| + 1e-8), so
  an element whose gradient sits at its sum's rounding level can step the
  other way. The fraction of elements whose update differs by more than
  half a learning rate stays within 5× that of the JAX routes or 1e-3,
  whichever is wider [decoder 0.075% / 0.059% against the routes' 0.073%
  / 0.068%; discriminator 0 and 0.009%, routes 0], and the relative error
  over the other elements within `limit` of the routes' [decoder 9.6e-3
  against 8.8e-3; discriminator ≤ 5.7e-5].
* the discriminator's spectral-norm vectors (and PatchGAN BatchNorm stats)
  after the step: elementwise within `limit` of the routes' largest
  relative difference; the decoder's BatchNorm running stats rtol 1e-4,
  atol 1e-6.

A fifth case runs the PatchGAN with ActNorm in place of batch norm (one
inner loop); its ActNorms initialise on the first train-mode forward, the
reconstruction's, and their captured statistics are held as the
spectral-norm vectors are.

The encoder's codebook is k-means on the batch's features, as a second
stage starts (the trainer's `use_init_embed` gate); on the random initial
codebook one near-tie id out of 8,192 flipped between the frameworks
and moved the losses by 1e-3.

The stale reconstruction is checked by planting the opposite: the
discriminator loop fed the post-update reconstruction. Reading (U-Net
discriminator, one inner loop): the loop's losses off by 2.5e-3 (dis),
4.6e-3 (cutmix) and 8.1e-2 (consistency) against rtol 1e-4, the
discriminator's gradients by 3.4e-2 against a limit of 1e-4, 0.58% of its
updates flipped against 0.1%; the generator's losses, computed before the
loop, still agree.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.discriminator import NLayerDiscriminator as JNLayer
from medical_image_editing_tpu.models.unet_discriminator import UNetDiscriminator as JUNetD
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.models.unet_encoder import init_codebook_from_batch
from medical_image_editing_tpu.ops.cutmix import cutmix_coordinates as j_cutmix_coordinates
from medical_image_editing_tpu.train import second_stage as jss
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.utils.config import load_json as jload_json
from medical_image_editing_tpu_torch.models import UNetDecoder
from medical_image_editing_tpu_torch.models.discriminator import NLayerDiscriminator
from medical_image_editing_tpu_torch.models.unet_discriminator import UNetDiscriminator
from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
from medical_image_editing_tpu_torch.train import second_stage as tss
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.config import load_json

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_second_stage.json")
FILTERS = (4, 8, 16, 32, 64)
DICT = 10
B, SIZE = 2, 64
UNET, NLAYER = "UNetDiscriminator", "NLayerDiscriminator"
# the PatchGAN with ActNorm (its first train-mode forward, on the
# reconstruction, initialises each ActNorm) in place of batch norm
NLAYER_ACT = NLAYER + "/actnorm"
CASES = [(UNET, 1), (UNET, 2), (NLAYER, 1), (NLAYER, 2), (NLAYER_ACT, 1)]
METRICS = ["gen_total", "recon", "freq", "perceptual", "gen", "unet_perceptual",
           "dis_total", "dis", "cutmix", "consistency", "total"]
DIS_METRICS = {"dis_total", "dis", "cutmix", "consistency", "total"}
BASE_RTOL = 1e-4
# Adam's first step is ±lr wherever |g| ≫ 1e-8: an element whose gradient
# sits at the rounding level of its sum can step the other way. The JAX
# step's routes flip none of the discriminator's (its convolutions do not
# change with the route); the port flipped 1 of 10,961 PatchGAN weights,
# its gradient 4e-6 of its tensor's RMS
MAX_FLIPPED = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed=21):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    imgs = []
    for _ in range(B):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.05, 0.1), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img + 0.3 * rng.normal(size=img.shape), -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def _np(state):
    return SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                              for f in ("enc_vars", "dec_vars", "vq", "dis_vars", "dec_opt",
                                        "dis_opt")})


def _norm(dis_kind):
    return "actnorm" if dis_kind == NLAYER_ACT else "batchnorm"


def _jax_dis(dis_kind):
    if dis_kind == UNET:
        return JUNetD(D_ch=4, D_attn="0", resolution=128)
    return JNLayer(n_filters=8, n_layers=2, normalization=_norm(dis_kind),
                   apply_spectral_norm=True)


def _port_dis(dis_kind):
    if dis_kind == UNET:
        return UNetDiscriminator(D_ch=4, D_attn="0", resolution=128)
    return NLayerDiscriminator(n_filters=8, n_layers=2, normalization=_norm(dis_kind),
                               apply_spectral_norm=True)


def jax_draws(rng, n_inner, h, w):
    """The JAX step's CutMix draws from its state key, as port draws:
    [(((y0, y1), (x0, x1)), invert)] per inner iteration."""
    _, _, k_dis = jax.random.split(rng, 3)
    draws = []
    for key in jax.random.split(k_dis, n_inner):
        k_box, k_inv = jax.random.split(key)
        (y, x), _ = j_cutmix_coordinates(k_box, h, w)
        box = tuple(tuple(torch.tensor(int(v), dtype=torch.int32) for v in pair)
                    for pair in (y, x))
        draws.append((box, torch.tensor(bool(jax.random.uniform(k_inv) > 0.5))))
    return draws


@pytest.fixture(scope="module")
def jax_init():
    """Flax-initialised encoder, decoder and both discriminators (jitted inits)."""
    x = jnp.zeros((1, SIZE, SIZE, 1))
    jcfg = jload_json(CONFIG)
    jenc = JEncoder(filters=FILTERS, dict_size=DICT, momentum=float(jcfg.model.vqmodel.momentum),
                    knn_backend="pallas")
    jdec = JDecoder(out_channels=1, filters=FILTERS, dropped_skip_layers=(),
                    use_pixel_shuffle=False)
    enc_vars, vq = jax.jit(jenc.init)(jax.random.key(1), x)
    # the codebook a second stage starts from: k-means on the batch's
    # features (the trainer's `use_init_embed` gate), not random rows
    feats = jenc.module.apply(enc_vars, jnp.asarray(_images()), train=False)
    vq = init_codebook_from_batch(jax.random.key(6), feats, vq)
    dec_vars = jax.jit(lambda k1, k2, q: jdec.init({"params": k1, "dropblock": k2}, q,
                                                   train=False))(
        jax.random.key(2), jax.random.key(3), jnp.zeros((1, SIZE, SIZE, FILTERS[0])))
    dis = {t: (_jax_dis(t), jax.jit(lambda k, x, t=t: _jax_dis(t).init(k, x, train=False))(
        jax.random.key(5), x)) for t in (UNET, NLAYER, NLAYER_ACT)}
    return SimpleNamespace(jcfg=jcfg, jenc=jenc, jdec=jdec, enc_vars=enc_vars, vq=vq,
                           dec_vars=dict(dec_vars), dis=dis)


def _run_jax(ji, dis_type, n_inner, image, route):
    jcfg = ji.jcfg
    jdis, dis_vars = ji.dis[dis_type]
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    dis_tx = jstate.make_optimizer_from_config(jcfg.dis_optim)
    s0 = jstate.create_train_state(
        jax.random.key(4), ji.enc_vars, ji.dec_vars, ji.vq,
        jstate.make_optimizer_from_config(jcfg.enc_optim), dec_tx, dis_vars=dis_vars,
        dis_tx=dis_tx)
    cfg = jss.second_stage_config_from_json(jcfg.loss)._replace(n_inner_loops=n_inner)
    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = route
    try:
        with jax.default_matmul_precision("highest"):
            step = jax.jit(jss.make_second_stage_step(ji.jenc, ji.jdec, jdis, dec_tx, dis_tx,
                                                      loss_cfg=cfg,
                                                      dis_type=dis_type.split("/")[0]))
            s1, metrics = step(s0, jnp.asarray(image), 0.0)
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL")
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev
    return _np(s0), _np(s1), {k: float(v) for k, v in metrics.items()}, s0.rng


def port_models(s0, dis_type):
    cfg = load_json(CONFIG)
    enc = EncoderWithVQ(1, FILTERS, DICT, momentum=float(cfg.model.vqmodel.momentum),
                        knn_backend="pallas")
    dec = UNetDecoder(FILTERS[0], 1, FILTERS, dropped_skip_layers=(), use_pixel_shuffle=False)
    dis = _port_dis(dis_type)
    sds = bridge.from_jax_train_state(s0)
    enc.load_state_dict(sds["encoder"], strict=True)
    dec.load_state_dict(sds["decoder"], strict=True)
    dis.load_state_dict(sds["discriminator"], strict=True)
    state = tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim), device="cpu",
        discriminator=dis,
        dis_opt=tstate.make_optimizer_from_config(dis.parameters(), cfg.dis_optim))
    return cfg, state


def run_port(s0, dis_type, n_inner, image, draws, plant=None):
    """One port step from the JAX initial state; `plant(state)` may patch
    the state's modules and optimizers first."""
    cfg, state = port_models(s0, dis_type)
    if plant is not None:
        plant(state)
    before = {m: {k: v.clone() for k, v in getattr(state, m).state_dict().items()}
              for m in ("encoder", "decoder", "discriminator")}
    step = tss.make_second_stage_step(
        state.encoder, state.decoder, state.discriminator,
        loss_cfg=tss.second_stage_config_from_json(cfg.loss)._replace(n_inner_loops=n_inner),
        dis_type=dis_type.split("/")[0], device="cpu")
    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = "packed"
    try:
        state, metrics = step(state, image, draws=draws)
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL")
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev
    return SimpleNamespace(state=state, before=before,
                           metrics={k: float(v) for k, v in metrics.items()})


def _case_id(c):
    return f"{'actno' if c[0] == NLAYER_ACT else c[0][:5]}-{c[1]}"


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def case(request, jax_init):
    dis_type, n_inner = request.param
    image = _images()
    s0, s1, jm, rng = _run_jax(jax_init, dis_type, n_inner, image, "packed")
    _, s1_xla, jm_xla, _ = _run_jax(jax_init, dis_type, n_inner, image, "xla")
    draws = jax_draws(rng, n_inner, SIZE, SIZE) if dis_type == UNET else None
    port = run_port(s0, dis_type, n_inner, image, draws)
    return SimpleNamespace(dis_type=dis_type, n_inner=n_inner, image=image, draws=draws,
                           s0=s0, s1=s1, s1_xla=s1_xla, jm=jm, jm_xla=jm_xla, port=port)


def _sds(s):
    return bridge.from_jax_train_state(s)


def _params(module):
    return {k for k, _ in module.named_parameters()}


def limit(floor):
    return max(5 * floor, BASE_RTOL)


def _rel(a, b):
    return float((a - b).norm()) / float(b.norm())


def jax_moments(s, part):
    """Adam's first moment of `part` in a JAX state, under the port's keys."""
    opt = s.dec_opt if part == "decoder" else s.dis_opt
    mu = next(x for x in opt if hasattr(x, "mu")).mu
    variables = s.dec_vars if part == "decoder" else s.dis_vars
    tree = {**variables, "params": mu}
    return (bridge.from_jax_decoder(tree) if part == "decoder"
            else bridge.from_jax_discriminator(tree))


def moment_error(case, part):
    """‖m_port − m_jax‖ / ‖m_jax‖ for Adam's first moment over the
    parameters of `part` (after one step (1 − β1)·g: the gradients
    themselves), and the same between the JAX step's two routes."""
    module = getattr(case.port.state, part)
    opt = case.port.state.dec_opt if part == "decoder" else case.port.state.dis_opt
    names = sorted(_params(module))
    got = torch.cat([opt.state[p]["exp_avg"].flatten() for _, p in sorted(
        module.named_parameters())])
    want, xla = (torch.cat([jax_moments(s, part)[k].flatten() for k in names])
                 for s in (case.s1, case.s1_xla))
    return _rel(got, want), _rel(xla, want)


def delta_error(case, part, port=None):
    """The one-step parameter deltas of `part`, port against JAX and
    between the JAX step's two routes: each as (the fraction of elements
    whose update differs by more than half a learning rate — Adam's ±lr
    step turned the other way —, ‖Δ − Δjax‖ / ‖Δjax‖ over the other
    elements)."""
    port = port or case.port
    names = sorted(_params(getattr(port.state, part)))
    lr = (port.state.dec_opt if part == "decoder" else port.state.dis_opt).param_groups[0]["lr"]
    start = _sds(case.s0)[part]
    jax_d = torch.cat([(_sds(case.s1)[part][k] - start[k]).flatten() for k in names])
    xla_d = torch.cat([(_sds(case.s1_xla)[part][k] - start[k]).flatten() for k in names])
    now = getattr(port.state, part).state_dict()
    got_d = torch.cat([(now[k] - port.before[part][k]).flatten() for k in names])

    def compare(d):
        flipped = (d - jax_d).abs() > 0.5 * lr
        return float(flipped.float().mean()), _rel(d[~flipped], jax_d[~flipped])

    return compare(got_d), compare(xla_d)


def metric_within(case, name, metrics):
    want, xla = case.jm[name], case.jm_xla[name]
    atol = 1e-6 if name == "consistency" else 0.0
    rtol = BASE_RTOL
    if case.n_inner > 1 and name in DIS_METRICS:
        rtol = limit(abs(xla - want) / max(abs(want), 1e-12))
    return abs(metrics[name] - want) <= atol + rtol * abs(want)


def deltas_within(case, part, port=None):
    (flipped, err), (route_flipped, route_err) = delta_error(case, part, port)
    return flipped <= max(5 * route_flipped, MAX_FLIPPED) and err <= limit(route_err)


@pytest.mark.parametrize("name", METRICS)
def test_step_losses_match_jax(case, name):
    assert set(case.port.metrics) == set(case.jm) == set(METRICS)
    assert metric_within(case, name, case.port.metrics), (
        name, case.port.metrics[name], case.jm[name], case.jm_xla[name])
    if case.dis_type != UNET and name in ("cutmix", "consistency", "unet_perceptual"):
        assert case.port.metrics[name] == 0.0


@pytest.mark.parametrize("part", ["decoder", "discriminator"])
def test_step_gradients_match_jax(case, part):
    err, floor = moment_error(case, part)
    assert err <= limit(floor), (part, err, floor)


@pytest.mark.parametrize("part", ["decoder", "discriminator"])
def test_step_parameter_deltas_match_jax(case, part):
    assert deltas_within(case, part), (part, delta_error(case, part))


def test_step_spectral_norm_and_batchnorm_state_match_jax(case):
    """The discriminator's spectral-norm vectors (and the PatchGAN's
    BatchNorm stats) after the step, which advanced them once per forward,
    against JAX's; the decoder's BatchNorm running stats."""
    want, xla = _sds(case.s1)["discriminator"], _sds(case.s1_xla)["discriminator"]
    got = case.port.state.discriminator.state_dict()
    buffers = [k for k in got if k.endswith(("u0", "sv0", "weight_u", "running_mean",
                                             "running_var", "data_loc", "data_scale"))]
    assert buffers
    for k in buffers:
        floor = float((xla[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-12)
        tol = limit(floor)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol, atol=1e-6 + tol,
                                   err_msg=k)
    dec_want = _sds(case.s1)["decoder"]
    for k, v in case.port.state.decoder.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), dec_want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_step_freezes_the_encoder_and_codebook(case):
    port = case.port
    for k, v in port.state.encoder.state_dict().items():
        assert torch.equal(v, port.before["encoder"][k]), k
    np.testing.assert_array_equal(case.s1.vq.embed, case.s0.vq.embed)
    assert port.state.step == 1 and not port.state.enc_opt.state
    assert not port.state.encoder.training
    # the discriminator's weight gradients came from its own loss only
    assert port.state.dis_opt.state and port.state.dec_opt.state


def _plant_fresh_recon(state):
    """The loop fed the post-update reconstruction: after the decoder's
    Adam step, its forward output (the tensor the step keeps as the
    loop's input) is overwritten with the updated decoder's output on the
    same quantized input, with the BatchNorm stats left as they were."""
    seen = {}
    dec = state.decoder
    dec.register_forward_hook(lambda m, args, out: seen.update(q=args[0], out=out))
    step = state.dec_opt.step

    def fresh_step(*a, **kw):
        result = step(*a, **kw)
        stats = {k: v.clone() for k, v in dec.state_dict().items() if "running" in k}
        with torch.no_grad():
            seen["out"].copy_(dec(seen["q"]))
        dec.load_state_dict(stats, strict=False)
        return result

    state.dec_opt.step = fresh_step


def test_planted_fresh_recon_fails_the_comparison(jax_init):
    """With the loop on the post-update reconstruction (U-Net
    discriminator, one inner loop) the discriminator's losses, gradients
    and updates leave the limits that the stale reconstruction meets (the
    reading is in the module docstring)."""
    image = _images()
    s0, s1, jm, rng = _run_jax(jax_init, UNET, 1, image, "packed")
    _, s1_xla, jm_xla, _ = _run_jax(jax_init, UNET, 1, image, "xla")
    draws = jax_draws(rng, 1, SIZE, SIZE)
    planted = SimpleNamespace(dis_type=UNET, n_inner=1, s0=s0, s1=s1, s1_xla=s1_xla, jm=jm,
                              jm_xla=jm_xla,
                              port=run_port(s0, UNET, 1, image, draws, _plant_fresh_recon))
    # the generator's losses precede the loop: unaffected
    for name in ("gen_total", "recon", "gen"):
        assert metric_within(planted, name, planted.port.metrics), name
    failed = [n for n in ("dis", "cutmix", "consistency")
              if not metric_within(planted, n, planted.port.metrics)]
    grad_err, grad_floor = moment_error(planted, "discriminator")
    reading = dict(failed=failed, grad=(grad_err, grad_floor),
                   delta=delta_error(planted, "discriminator"), port=planted.port.metrics, jax=jm)
    assert failed and grad_err > limit(grad_floor), reading
    assert not deltas_within(planted, "discriminator"), reading


def test_step_draws_cutmix_from_the_state_generator(jax_init):
    """Without draws the step takes one (box, invert) per inner iteration
    from `state.generator`: two states seeded alike step alike, and the
    generator moves."""
    image = _images()
    s0 = SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(jax_init, f))
                            for f in ("enc_vars", "dec_vars", "vq")},
                         dis_vars=jax.tree.map(np.asarray, jax_init.dis[UNET][1]))
    results = []
    for _ in range(2):
        cfg, state = port_models(s0, UNET)
        step = tss.make_second_stage_step(
            state.encoder, state.decoder, state.discriminator,
            loss_cfg=tss.second_stage_config_from_json(cfg.loss)._replace(n_inner_loops=2),
            device="cpu")
        g0 = state.generator.get_state().clone()
        _, metrics = step(state, image)
        assert not torch.equal(g0, state.generator.get_state())
        results.append({k: float(v) for k, v in metrics.items()})
    assert results[0] == results[1]
    gen = torch.Generator().manual_seed(0)
    draws = tss.sample_cutmix_draws(gen, 3, SIZE, SIZE)
    assert len(draws) == 3 and all(d[1].dtype == torch.bool for d in draws)
