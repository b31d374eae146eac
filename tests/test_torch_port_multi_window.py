"""The multi-window trainer's window functions, its reconstruction loss and
its first-stage and second-stage steps, port vs JAX package, on the CPU at
small size: `train/multi_window.py` on the joint config's losses, weights
and optimizers (`configs/lung_multiwindow_joint.json`), the second step
with `use_unet_perceptual_loss` on (the config has it off; on, the
discriminator also runs on the real images, which moves the spectral-norm
order); encoder and decoder
filters (4, 8, 16, 32, 64), `dict_size` 5, the U-Net discriminator at
`D_ch` 4 and resolution 128 (fully convolutional up to its sum-pooled
bottleneck, so 64² images), batch 2, `knn_backend: "pallas"` and
`MEDIMG_CONV_IMPL=packed` (the JAX side runs its Pallas kernels in
interpret mode), float32. The joint step is in
`tests/test_torch_port_multi_window_joint.py`, the trainer in
`tests/test_torch_port_multi_window_trainer.py`.

Both sides start from the same flax-initialised variables (through
`utils/weights.py::load_jax_train_state`, the codebook k-means on the
batch's features so that no id sits at a near tie) and use the same random
numbers: the test replays the JAX steps' key splits
(`multi_window.py:179,262-272`, `first_stage.py:106`) into the port's
draws. Each JAX step is compiled once (module fixture).

Tolerances, float32. Window scaling magnifies differences: the lung
window multiplies the dataset's normalized values by 4096/1500 = 2.73, the
mediastinal by 4096/400 = 10.24, so a squared error there is up to
10.24² ≈ 105× the raw window's and carries 105× its absolute rounding.
* window functions: identity exact; lung and mediastinal rtol 1e-6 with
  atol 1e-6 × the window's factor (2.73, 10.24);
* the recon loss, each window alone and weighted: rtol 1e-5 (a relative
  tolerance scales with the window's factor by itself);
* the steps' losses: rtol 1e-4 (every loss of these steps is computed
  before any update), atol 1e-6 for the small consistency term;
* gradients (Adam's first moment), relative Frobenius norm over each
  module's parameters, within 5× the port's own f32 floor or 1e-4,
  whichever is wider; the one-step parameter deltas: the fraction of
  elements whose update differs by more than 1e-3·lr within 5× the
  floor's fraction or 1e-3. Adam's first step is lr·g/(|g| + 1e-8): ±lr
  wherever |g| ≫ 1e-8, so a gradient at the rounding level of its sum
  (a dead ReLU's 0 in one framework, 1e-10 in the other) moves by a
  fraction of lr, and one near 0 can turn. The floor is the same port step perturbed at
  the rounding level: oneDNN's convolutions off (PyTorch's native ones,
  another summation order) and the decoder's input (the quantized
  features) moved by one ulp up or down at random. The two frameworks'
  encoders round the straight-through sum x + (e − x) differently: their
  decoder inputs differ by one ulp (1.2e-7) at 1.4% of the entries, and
  where a quantized channel is constant over the batch, the decoder's
  BatchNorm divides that noise by √eps. Measured on the second step: the
  decoder's gradient 2.45e-3 from JAX's, 1.6e-5 when the port decodes
  JAX's quantized features, 2.45e-3 again under random one-ulp noise,
  1.1e-5 with the convolutions' order alone. The JAX step is compiled once
  here, so the floor comes from the port;
* the spectral-norm vectors after the step: elementwise within the same
  limit of the largest relative floor difference, atol 1e-6 + that limit;
  the decoder's BatchNorm running stats and the VQ state rtol 1e-4, atol
  1e-6.

Readings on this suite's CPU host (port vs JAX; the floor run's in
brackets): losses ≤ 2.4e-6 relative in all three steps. First step:
encoder gradient 0.207 (0.212), decoder 1.3e-5 (9.1e-3); updates off by
more than 1e-3·lr: encoder 6.8% (7.1%), decoder 0.20% (0.52%). Second
step: decoder 2.45e-3 (2.45e-3), discriminator 1.2e-5 (3.3e-7, so the
1e-4 limit holds it); updates decoder 0.29% (0.29%), discriminator 0.004%
(0). The joint step's are in its own file. The encoder's gradient at these
toy widths is as ill-conditioned as the first-stage test found: its checks
catch only gross faults; the decoder's and discriminator's are tight.
"""

import contextlib
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.unet_discriminator import UNetDiscriminator as JUNetD
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.models.unet_encoder import init_codebook_from_batch
from medical_image_editing_tpu.ops import windowing as jwin
from medical_image_editing_tpu.ops.cutmix import cutmix_coordinates as j_cutmix_coordinates
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import multi_window as jmw
from medical_image_editing_tpu.train import second_stage as jss
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.utils.config import load_json as jload_json
from medical_image_editing_tpu_torch.models import UNetDecoder
from medical_image_editing_tpu_torch.models.unet_discriminator import UNetDiscriminator
from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
from medical_image_editing_tpu_torch.ops import windowing as twin
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import multi_window as tmw
from medical_image_editing_tpu_torch.train import second_stage as tss
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.config import load_json
from test_torch_port_augment import jax_view_draws, to_torch_draws

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_multiwindow_joint.json")
FILTERS = (4, 8, 16, 32, 64)
DICT = 5
B, SIZE = 2, 64
DSW = (4096.0, 0.0, 2.0)
WINDOW_FACTOR = (1.0, 4096 / 1500, 4096 / 400)
BASE_RTOL = 1e-4
MAX_MISMATCH = 1e-3
FIRST_METRICS = ["total", "commit", "cross", "dist", "reg", "recon", "freq", "perceptual"]
SECOND_METRICS = ["gen_total", "recon", "freq", "perceptual", "gen", "unet_perceptual",
                  "dis_total", "dis", "cutmix", "consistency", "total"]
JOINT_METRICS = ["gen_total", "commit", "cross", "dist", "reg", "recon", "freq", "perceptual",
                 "gen", "unet_perceptual", "dis_total", "dis", "cutmix", "consistency", "total"]
MODULES = {"first": ("encoder", "decoder"), "second": ("decoder", "discriminator"),
           "joint": ("encoder", "decoder", "discriminator")}
OPT = {"encoder": "enc_opt", "decoder": "dec_opt", "discriminator": "dis_opt"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared with the joint step's file
# ---------------------------------------------------------------------------
def images(seed=21):
    """Smooth slices with blobs and noise in [-1, 1], (B,H,W,1)."""
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


# the second step runs with the U-Net perceptual term on (weight 1); the
# joint step as the config ships it, off (one JAX compile fewer forwards)
UNET_PERCEPTUAL = {"first": False, "second": True, "joint": False}


def loss_configs(fs, ss, cfg, kind):
    """Both stages' loss configs of `kind`'s step from the joint config
    through the modules `fs`, `ss` (JAX's or the port's)."""
    sc = ss.second_stage_config_from_json(cfg.loss)
    if UNET_PERCEPTUAL[kind]:
        sc = sc._replace(use_unet_perceptual_loss=True, w_unet_perceptual=1.0)
    return fs.loss_config_from_json(cfg.loss), sc


def window_weights(cfg):
    return {k: tuple(float(v) for v in getattr(cfg.loss, k))
            for k in ("recon_weights", "freq_weights", "percep_weights")}


def jax_init():
    """Flax-initialised encoder, decoder and U-Net discriminator (jitted
    inits); the codebook k-means on the batch's features."""
    x = jnp.zeros((1, SIZE, SIZE, 1))
    jcfg = jload_json(CONFIG)
    jenc = JEncoder(filters=FILTERS, dict_size=DICT, momentum=float(jcfg.model.vqmodel.momentum),
                    knn_backend="pallas")
    jdec = JDecoder(out_channels=1, filters=FILTERS, dropped_skip_layers=(),
                    use_pixel_shuffle=False)
    jdis = JUNetD(D_ch=4, D_attn="0", resolution=128)
    enc_vars, vq = jax.jit(jenc.init)(jax.random.key(1), x)
    feats = jenc.module.apply(enc_vars, jnp.asarray(images()), train=False)
    vq = init_codebook_from_batch(jax.random.key(6), feats, vq)
    dec_vars = jax.jit(lambda k1, k2, q: jdec.init({"params": k1, "dropblock": k2}, q,
                                                   train=False))(
        jax.random.key(2), jax.random.key(3), jnp.zeros((1, SIZE, SIZE, FILTERS[0])))
    dis_vars = jax.jit(lambda k, x: jdis.init(k, x, train=False))(jax.random.key(5), x)
    return SimpleNamespace(jcfg=jcfg, jenc=jenc, jdec=jdec, jdis=jdis, enc_vars=enc_vars, vq=vq,
                           dec_vars=dict(dec_vars), dis_vars=dis_vars)


def _np(state):
    return SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                              for f in ("enc_vars", "dec_vars", "vq", "dis_vars", "enc_opt",
                                        "dec_opt", "dis_opt")})


def run_jax(ji, kind, image):
    """One JAX step of `kind` ("first", "second", "joint") from the initial
    state, packed conv route: (s0, s1 as numpy, metrics, s0's key)."""
    jcfg = ji.jcfg
    txs = [jstate.make_optimizer_from_config(c)
           for c in (jcfg.enc_optim, jcfg.dec_optim, jcfg.dis_optim)]
    s0 = jstate.create_train_state(jax.random.key(4), ji.enc_vars, ji.dec_vars, ji.vq, txs[0],
                                   txs[1], dis_vars=ji.dis_vars, dis_tx=txs[2])
    fc, sc = loss_configs(jfs, jss, jcfg, kind)
    mw = dict(dataset_window=DSW, **window_weights(jcfg))
    if kind == "first":
        step = jmw.make_multi_window_first_stage_step(
            ji.jenc, ji.jdec, txs[0], txs[1], loss_cfg=fc, aug_cfg=jcfg.augmentation,
            dict_size=DICT, **mw)
    elif kind == "second":
        step = jmw.make_multi_window_second_stage_step(ji.jenc, ji.jdec, ji.jdis, txs[1], txs[2],
                                                       loss_cfg=sc, **mw)
    else:
        step = jmw.make_joint_step(ji.jenc, ji.jdec, ji.jdis, *txs, first_cfg=fc,
                                   second_cfg=sc, aug_cfg=jcfg.augmentation, dict_size=DICT,
                                   **mw)
    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = "packed"
    try:
        with jax.default_matmul_precision("highest"):
            s1, metrics = jax.jit(step)(s0, jnp.asarray(image), 0.0)
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL")
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev
    return _np(s0), _np(s1), {k: float(v) for k, v in metrics.items()}, s0.rng


def cutmix_draws(k_dis, h, w, n=3):
    """The JAX steps' CutMix draws from their `k_dis` key, as port draws:
    one (((y0, y1), (x0, x1)), invert) per window."""
    draws = []
    for key in jax.random.split(k_dis, n):
        k_box, k_inv = jax.random.split(key)
        (y, x), _ = j_cutmix_coordinates(k_box, h, w)
        box = tuple(tuple(torch.tensor(int(v), dtype=torch.int32) for v in pair)
                    for pair in (y, x))
        draws.append((box, torch.tensor(bool(jax.random.uniform(k_inv) > 0.5))))
    return draws


def port_draws(kind, rng, aug_cfg):
    """The JAX step's draws from its state key `rng`, in the port step's
    layout."""
    if kind == "second":
        return cutmix_draws(jax.random.split(rng, 3)[2], SIZE, SIZE)
    keys = jax.random.split(rng, 5 if kind == "first" else 6)
    views = tuple(to_torch_draws(jax_view_draws(k, aug_cfg, B, SIZE, SIZE))
                  for k in keys[1:3])
    return views if kind == "first" else (*views, cutmix_draws(keys[5], SIZE, SIZE))


def port_state(s0, kind):
    """The port's state of `kind` from the JAX initial state."""
    cfg = load_json(CONFIG)
    enc = EncoderWithVQ(1, FILTERS, DICT, momentum=float(cfg.model.vqmodel.momentum),
                        knn_backend="pallas")
    dec = UNetDecoder(FILTERS[0], 1, FILTERS, dropped_skip_layers=(), use_pixel_shuffle=False)
    dis = dis_opt = None
    if kind != "first":
        dis = UNetDiscriminator(D_ch=4, D_attn="0", resolution=128)
        dis_opt = tstate.make_optimizer_from_config(dis.parameters(), cfg.dis_optim)
    state = tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim), device="cpu",
        discriminator=dis, dis_opt=dis_opt)
    return cfg, bridge.load_jax_train_state(state, s0)


def port_step(cfg, state, kind, **kw):
    """The port's step of `kind` on `state`'s models; `kw` goes to the GAN
    steps (`use_remat`, `per_window_backward`)."""
    fc, sc = loss_configs(tfs, tss, cfg, kind)
    mw = dict(dataset_window=DSW, **window_weights(cfg), device="cpu")
    if kind == "first":
        return tmw.make_multi_window_first_stage_step(
            state.encoder, state.decoder, loss_cfg=fc, aug_cfg=cfg.augmentation,
            dict_size=DICT, **mw)
    if kind == "second":
        return tmw.make_multi_window_second_stage_step(
            state.encoder, state.decoder, state.discriminator, loss_cfg=sc, **mw, **kw)
    return tmw.make_joint_step(state.encoder, state.decoder, state.discriminator, first_cfg=fc,
                               second_cfg=sc, aug_cfg=cfg.augmentation, dict_size=DICT,
                               **mw, **kw)


@contextlib.contextmanager
def rounding_floor(seed=0):
    """Inside the block the steps run perturbed at the rounding level:
    PyTorch's native CPU convolutions instead of oneDNN's, and the
    quantized features moved by one ulp up or down at random (the
    gradient still flows through the straight-through estimator)."""
    gen = torch.Generator().manual_seed(seed)
    real = tfs.encode_quantize

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        up = torch.randint(0, 2, q.shape, generator=gen).bool()
        moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
        return (q + (moved - q).detach(), *rest)

    tfs.encode_quantize = tmw.encode_quantize = nudged
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        tfs.encode_quantize = tmw.encode_quantize = real


def run_port(s0, kind, image, draws, *, floor=False, **kw):
    """One port step from the JAX initial state, packed route (on the CPU,
    the kernels' plain versions); `floor` runs it under `rounding_floor`."""
    cfg, state = port_state(s0, kind)
    before = {m: {k: v.clone() for k, v in getattr(state, m).state_dict().items()}
              for m in ("encoder", "decoder", "discriminator") if getattr(state, m) is not None}
    step = port_step(cfg, state, kind, **kw)
    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = "packed"
    try:
        with rounding_floor() if floor else contextlib.nullcontext():
            state, metrics = step(state, image, draws=draws)
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL")
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev
    return SimpleNamespace(state=state, before=before,
                           metrics={k: float(v) for k, v in metrics.items()})


def make_case(ji, kind):
    image = images()
    s0, s1, jm, rng = run_jax(ji, kind, image)
    draws = port_draws(kind, rng, ji.jcfg.augmentation)
    return SimpleNamespace(kind=kind, image=image, draws=draws, s0=s0, s1=s1, jm=jm,
                           port=run_port(s0, kind, image, draws),
                           floor=run_port(s0, kind, image, draws, floor=True))


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def limit(floor, base=BASE_RTOL):
    return max(5 * floor, base)


def _params(module):
    return sorted(k for k, _ in module.named_parameters())


def jax_moments(s, part):
    """Adam's first moment of `part` in a JAX state, under the port's keys."""
    opt = getattr(s, OPT[part])
    mu = next(x for x in opt if hasattr(x, "mu")).mu
    if part == "encoder":
        return bridge.from_jax_encoder({"params": mu})
    if part == "decoder":
        return bridge.from_jax_decoder({**s.dec_vars, "params": mu})
    return bridge.from_jax_discriminator({**s.dis_vars, "params": mu})


def port_moments(port, part):
    module = getattr(port.state, part)
    opt = getattr(port.state, OPT[part])
    return torch.cat([opt.state[p]["exp_avg"].flatten() for _, p in sorted(
        module.named_parameters())])


def moment_error(case, part):
    """(port vs JAX, port vs its own floor run) relative Frobenius error of
    Adam's first moment after one step ((1 − β1)·g: the gradients)."""
    want = torch.cat([jax_moments(case.s1, part)[k].flatten()
                      for k in _params(getattr(case.port.state, part))])
    got, floor = port_moments(case.port, part), port_moments(case.floor, part)
    return _rel(got, want), _rel(floor, got)


def _deltas(port, part):
    module = getattr(port.state, part)
    now = module.state_dict()
    return torch.cat([(now[k] - port.before[part][k]).flatten() for k in _params(module)])


def delta_error(case, part, port=None):
    """One-step parameter deltas of `part`: the fraction of elements whose
    update differs by more than 1e-3·lr, port vs JAX and floor run vs
    port."""
    port = port or case.port
    lr = getattr(port.state, OPT[part]).param_groups[0]["lr"]
    start = bridge.from_jax_train_state(case.s0)[part]
    end = bridge.from_jax_train_state(case.s1)[part]
    jax_d = torch.cat([(end[k] - start[k]).flatten() for k in _params(getattr(port.state, part))])
    got = _deltas(port, part)

    def mismatch(d, ref):
        return float(((d - ref).abs() > 1e-3 * lr).float().mean())

    return mismatch(got, jax_d), mismatch(_deltas(case.floor, part), got)


def deltas_within(case, part, port=None):
    err, floor = delta_error(case, part, port)
    return err <= max(5 * floor, MAX_MISMATCH)


def metric_within(case, name, metrics):
    want = case.jm[name]
    atol = 1e-6 if name == "consistency" else 0.0
    atol = 1e-3 if name == "dist" else atol  # the pair sum's diagonal (first-stage test)
    return abs(metrics[name] - want) <= atol + BASE_RTOL * abs(want)


def check_buffers(case):
    """The spectral-norm vectors (where there is a discriminator), the
    decoder's BatchNorm running stats and the VQ state after the step."""
    want_all = bridge.from_jax_train_state(case.s1)
    if case.port.state.discriminator is not None:
        want = want_all["discriminator"]
        got = case.port.state.discriminator.state_dict()
        floor = case.floor.state.discriminator.state_dict()
        sn = [k for k in got if k.endswith(("u0", "sv0"))]
        assert sn
        for k in sn:
            f = float((floor[k] - got[k]).abs().max()) / max(float(got[k].abs().max()), 1e-12)
            tol = limit(f)
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol,
                                       atol=1e-6 + tol, err_msg=k)
    dec_want = want_all["decoder"]
    for k, v in case.port.state.decoder.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), dec_want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for got, want in zip(case.port.state.vq, case.s1.vq):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# window functions and the recon loss
# ---------------------------------------------------------------------------
def test_windows_match_jax():
    assert vars(twin.MEDIASTINAL_WINDOW) == vars(jwin.MEDIASTINAL_WINDOW)
    assert vars(twin.LUNG_WINDOW) == vars(jwin.LUNG_WINDOW)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    for i, (tf, jf) in enumerate(zip(tmw.window_fns(DSW), jmw.window_fns(DSW))):
        got, want = tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x)))
        if i == 0:
            np.testing.assert_array_equal(got, x)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * WINDOW_FACTOR[i])


@pytest.mark.parametrize("weights", [((1, 0, 0), (0, 0, 0)), ((0, 1, 0), (0, 0, 0)),
                                     ((0, 0, 1), (0, 0, 0)), ((0, 0, 0), (1, 0, 0)),
                                     ((0, 0, 0), (0, 0, 1)), ((1.0, 0.5, 2.0), (0.3, 1.0, 0.7))],
                         ids=["raw", "lung", "mediastinal", "freq_raw", "freq_mediastinal",
                              "weighted"])
def test_multiwindow_recon_loss_matches_jax(weights):
    """Each window alone and a weighted mix; MSE and focal frequency; the
    perceptual term 0 on both sides (no `perceptual_fn`)."""
    rw, fw = weights
    rng = np.random.default_rng(1)
    r = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    t = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    cfg = jfs.FirstStageLossConfig()
    got = tmw.make_multiwindow_recon_loss(cfg, DSW, rw, fw)(torch.from_numpy(r),
                                                            torch.from_numpy(t))
    want = jmw.make_multiwindow_recon_loss(cfg, DSW, rw, fw, (1, 1, 1))(jnp.asarray(r),
                                                                       jnp.asarray(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert float(got[2]) == 0.0
    if rw == (1, 0, 0) and fw == (0, 0, 0):  # only the raw window, weight 1, over 3 windows
        np.testing.assert_allclose(float(got[0]), np.mean((r - t) ** 2) / 3, rtol=1e-5)


# ---------------------------------------------------------------------------
# the first and second steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ji():
    return jax_init()


@pytest.fixture(scope="module")
def cases(ji):
    """Each step's case, made at its first use (one JAX compile each)."""
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = make_case(ji, kind)
        return made[kind]

    return get


METRIC_CASES = ([("first", n) for n in FIRST_METRICS]
                + [("second", n) for n in SECOND_METRICS])
PART_CASES = [(k, p) for k in ("first", "second") for p in MODULES[k]]


@pytest.mark.parametrize("kind,name", METRIC_CASES)
def test_step_losses_match_jax(cases, kind, name):
    case = cases(kind)
    names = FIRST_METRICS if kind == "first" else SECOND_METRICS
    assert set(case.port.metrics) == set(case.jm) == set(names)
    assert metric_within(case, name, case.port.metrics), (
        name, case.port.metrics[name], case.jm[name])


@pytest.mark.parametrize("kind,part", PART_CASES)
def test_step_gradients_match_jax(cases, kind, part):
    err, floor = moment_error(cases(kind), part)
    assert err <= limit(floor), (part, err, floor)


@pytest.mark.parametrize("kind,part", PART_CASES)
def test_step_parameter_deltas_match_jax(cases, kind, part):
    case = cases(kind)
    assert deltas_within(case, part), (part, delta_error(case, part))


@pytest.mark.parametrize("kind", ["first", "second"])
def test_step_buffers_match_jax(cases, kind):
    check_buffers(cases(kind))


def test_second_step_freezes_the_encoder(cases):
    port = cases("second").port
    for k, v in port.state.encoder.state_dict().items():
        assert torch.equal(v, port.before["encoder"][k]), k
    assert not port.state.enc_opt.state and not port.state.encoder.training
    assert cases("first").port.state.discriminator is None


def test_second_step_refuses_the_patchgan():
    from medical_image_editing_tpu_torch.models.discriminator import NLayerDiscriminator

    cfg = load_json(CONFIG)
    enc = EncoderWithVQ(1, FILTERS, DICT)
    dec = UNetDecoder(FILTERS[0], 1, FILTERS, dropped_skip_layers=(), use_pixel_shuffle=False)
    for make in (tmw.make_multi_window_second_stage_step, tmw.make_joint_step):
        kw = dict(loss_cfg=tss.second_stage_config_from_json(cfg.loss))
        if make is tmw.make_joint_step:
            kw = dict(first_cfg=tfs.loss_config_from_json(cfg.loss), second_cfg=kw["loss_cfg"],
                      aug_cfg=cfg.augmentation, dict_size=DICT)
        with pytest.raises(ValueError, match="UNetDiscriminator"):
            make(enc, dec, NLayerDiscriminator(n_filters=4, n_layers=1), dataset_window=DSW,
                 device="cpu", **kw)


def test_second_step_draws_from_the_state_generator(ji):
    """Without draws the second step takes one (box, invert) per window
    from `state.generator`: two states seeded alike step alike, and the
    generator moves."""
    s0 = SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(ji, f))
                            for f in ("enc_vars", "dec_vars", "vq", "dis_vars")})
    results = []
    for _ in range(2):
        cfg, state = port_state(s0, "second")
        g0 = state.generator.get_state().clone()
        _, metrics = port_step(cfg, state, "second")(state, images())
        assert not torch.equal(g0, state.generator.get_state())
        results.append({k: float(v) for k, v in metrics.items()})
    assert results[0] == results[1]
