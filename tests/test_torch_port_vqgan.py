"""The VQGAN, ActNorm and the VQGAN training step, port vs JAX package, on the
CPU at the JAX package's own test sizes (`tests/test_vqgan.py`): `mid_channels`
4, `emb_dim` 8, `dict_size` 6, multipliers (1, 2, 4), one res block a level,
decoder attention at 8², 32² input, batch 2; the U-Net discriminator at
`D_ch` 4, resolution 128 (fully convolutional up to its sum-pooled
bottleneck); the losses, weights and optimizers of `configs/crc_vqgan.json`
(recon ×10, focal frequency, commit, gen, U-Net perceptual ×1, hinge,
CutMix, consistency, one inner loop), `knn_backend: "pallas"` (the JAX side
runs its Pallas kernel in interpret mode on the CPU), float32.

Both sides start from the same flax-initialised variables (through
`utils/weights.py::from_jax_vqgan` and `load_jax_train_state`) and use the
same CutMix draws: the test replays the JAX step's key splits
(`vqgan_stage.py:53,184-191`) into the port's. The JAX step is compiled
once (module fixture) and run twice.

Tolerances, float32 (readings on this suite's CPU host at the end):
* blocks, forward and `generate_image_from_ids`: the ids exactly; outputs
  within the measured floor of two f32 evaluation orders (flax's GroupNorm
  takes the variance as E[x²] − E[x]², torch's in two passes; XLA's and
  oneDNN's convolutions sum in other orders): rtol 1e-5 with atol 1e-5 ×
  the output's largest magnitude;
* ActNorm: the captured statistics and outputs rtol 1e-5, atol 1e-6;
  `logdet` rtol 1e-5;
* the steps: the ids are held first (the port's eval-forward ids equal
  JAX's on the start and on JAX's state after step 1); then every
  quantity within max(5 × floor, 1e-4) (relative), the floor measured in
  the same run as the port's own steps perturbed at the rounding level:
  PyTorch's native CPU convolutions instead of oneDNN's, and the quantized
  features moved by one ulp up or down at random (the gradient still
  flows straight through). Losses (atol 1e-6 for the small consistency
  term); gradients read from Adam's first moment (relative Frobenius norm
  over each module's parameters); the parameter updates: the fraction of
  elements whose update differs by more than 1e-3·lr (Adam's first step
  is ±lr wherever |g| ≫ 1e-8, so an element at its sum's rounding level
  can turn) within max(5 × the floor's fraction, 1e-3); the codebook's
  buffers and the spectral-norm vectors elementwise with atol 1e-6 +
  the limit.

Readings (port vs JAX; the floor run's in brackets), steps 1 and 2:
losses ≤ 6.7e-7 and ≤ 3.1e-6 relative (≤ 2.0e-7); gradients VQGAN 1.5e-6
and 1.4e-6 (1.5e-6, 1.1e-6), discriminator 1.5e-6 and 2.5e-6 (1.4e-6,
2.4e-6); updates off by more than 1e-3·lr: VQGAN 0.71% and 0.72% (0.70%,
0.72%), discriminator 0.0008% (0.0024%); the codebook ≤ 7.1e-8 relative;
the spectral-norm vectors ≤ 3.3e-7 abs. The 1e-4 floor of the limit
holds everything here.
"""

import contextlib
import os
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models.actnorm import ActNorm as JActNorm
from medical_image_editing_tpu.models.discriminator import NLayerDiscriminator as JNLayer
from medical_image_editing_tpu.models.unet_discriminator import UNetDiscriminator as JUNetD
from medical_image_editing_tpu.models import vqgan as jvqgan
from medical_image_editing_tpu.ops.vq import vq_init
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import second_stage as jss
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.train.vqgan_stage import make_vqgan_step as j_make_vqgan_step
from medical_image_editing_tpu.utils import torch_export
from medical_image_editing_tpu.utils.config import load_json as jload_json
from medical_image_editing_tpu_torch.models import vqgan as tvqgan
from medical_image_editing_tpu_torch.models.actnorm import ActNorm
from medical_image_editing_tpu_torch.models.discriminator import NLayerDiscriminator
from medical_image_editing_tpu_torch.models.unet_discriminator import UNetDiscriminator
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import second_stage as tss
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.train import vqgan_stage as tvs
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.config import load_json
from test_torch_port_second_stage import jax_draws

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "crc_vqgan.json")
KW = dict(in_channels=1, mid_channels=4, out_channels=1, emb_dim=8, dict_size=6,
          enc_ch_multiplier=(1, 2, 4), dec_ch_multiplier=(1, 2, 4), num_res_blocks=1,
          enc_attn_resolutions=(), dec_attn_resolutions=(8,), resolution=32,
          knn_backend="pallas")
B, SIZE = 2, 32
BASE_RTOL = 1e-4
MAX_MISMATCH = 1e-3
METRICS = ["gen_total", "recon", "freq", "perceptual", "commit", "gen", "unet_perceptual",
           "dis_total", "dis", "cutmix", "consistency", "total"]
OPT = {"vqgan": "dec_opt", "discriminator": "dis_opt"}
SLOT = {"vqgan": "decoder", "discriminator": "discriminator"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(seed=21, size=SIZE):
    """Smooth slices with blobs and noise in [-1, 1], (B,H,W,1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(B):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.05, 0.1), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img + 0.3 * rng.normal(size=img.shape), -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, rtol=1e-5):
    """rtol with atol rtol × the largest magnitude of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def ji():
    """The JAX VQGAN (jitted init) and its random-normal codebook, and the
    U-Net discriminator."""
    m = jvqgan.VQGAN(**KW)
    vq = vq_init(jax.random.key(41), KW["dict_size"], KW["emb_dim"])
    x0 = jnp.zeros((1, SIZE, SIZE, 1))
    variables = jax.jit(lambda k: m.init(k, x0, vq, train=False))(jax.random.key(0))
    jdis = JUNetD(D_ch=4, D_attn="0", resolution=128)
    dis_vars = jax.jit(lambda k: jdis.init(k, x0, train=False))(jax.random.key(5))
    return SimpleNamespace(m=m, vq=vq, variables=variables, jdis=jdis, dis_vars=dis_vars)


def port_vqgan(ji):
    t = tvqgan.VQGAN(**KW)
    t.load_state_dict(bridge.from_jax_vqgan(_np(ji.variables), _np(ji.vq), t), strict=True)
    return t


# ---------------------------------------------------------------------------
# blocks, the forward, the painted decode, reference keys
# ---------------------------------------------------------------------------
def _block_case(name):
    """(flax module, port module, weight loader, input (NHWC)) of a block."""
    rng = np.random.default_rng(3)
    if name.startswith("resnet"):
        cin, cout, short = {"resnet_same": (8, 8, False), "resnet_nin": (4, 8, False),
                            "resnet_conv_shortcut": (4, 12, True)}[name]
        jm = jvqgan.ResnetBlock(cout, use_conv_shortcut=short)
        tm = tvqgan.ResnetBlock(cin, cout, use_conv_shortcut=short)
        load = lambda out, p: bridge._vqgan_resnet(out, "m", p, tm)  # noqa: E731
        shape = (2, 8, 8, cin)
    elif name == "attn":
        jm, tm = jvqgan.AttnBlock(), tvqgan.AttnBlock(16)
        load = lambda out, p: bridge._vqgan_attn(out, "m", p)  # noqa: E731
        shape = (2, 8, 8, 16)
    else:
        jm = jvqgan.Downsample() if name == "downsample" else jvqgan.Upsample()
        tm = (tvqgan.Downsample if name == "downsample" else tvqgan.Upsample)(8)
        load = lambda out, p: bridge._conv(out, "m.conv", p["Conv_0"])  # noqa: E731
        shape = (2, 9 if name == "downsample" else 8, 8, 8)
    x = rng.normal(size=shape).astype(np.float32)
    return jm, tm, load, x


@pytest.mark.parametrize("name", ["resnet_same", "resnet_nin", "resnet_conv_shortcut", "attn",
                                  "downsample", "upsample"])
def test_blocks_match_jax(name):
    jm, tm, load, x = _block_case(name)
    variables = jm.init(jax.random.key(7), jnp.asarray(x))
    params = _np(variables["params"])
    # GroupNorm's flax scale/bias start at 1/0: move them, so that the
    # mapping is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * np.float32(len(str(p)) % 5) if "GroupNorm" in str(p) else v,
        params)
    sd = {}
    load(sd, params)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("channels,groups", [(64, 32), (96, 32), (16, 16), (8, 8), (12, 4)])
def test_group_norm_groups(channels, groups):
    gn = tvqgan.group_norm(channels)
    assert gn.num_groups == groups and gn.eps == 1e-6
    x = np.random.default_rng(4).normal(size=(2, 4, 4, channels)).astype(np.float32) * 3 + 1

    class Norm(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jvqgan._norm(x)

    want = np.asarray(Norm().apply({"params": {"GroupNorm_0": {
        "scale": np.ones(channels, np.float32), "bias": np.zeros(channels, np.float32)}}},
        jnp.asarray(x)))
    with torch.no_grad():
        close(_nhwc(gn(_nchw(x))), want)


def test_group_norm_statistics_on_the_cpu():
    """Groups whose |mean| is many times their std, in the channels-last
    layout oneDNN's CPU convolutions return (as the first convolution's
    output on a smooth slice): the port's GroupNorm on the CPU agrees with
    a float64 evaluation to 1e-6 (ATen's CPU kernel on this input: 5.9e-5
    relative); flax's, whose variance is E[x²] − E[x]², is further from it,
    and the port is within flax's own error of flax."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 32, 64, 64)) * 0.05 + rng.uniform(-1, 1, (1, 32, 1, 1))).astype(
        np.float32)
    gn = tvqgan.group_norm(32)
    with torch.no_grad():
        gn.weight.copy_(torch.linspace(0.5, 1.5, 32))
        gn.bias.copy_(torch.linspace(-0.2, 0.2, 32))
        got = gn(torch.from_numpy(x).to(memory_format=torch.channels_last)).double()
        want = torch.nn.functional.group_norm(torch.from_numpy(x).double(), 32,
                                              gn.weight.double(), gn.bias.double(), 1e-6)
    assert float((got - want).norm() / want.norm()) <= 1e-6

    class Norm(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jvqgan._norm(x)

    params = {"GroupNorm_0": {"scale": gn.weight.detach().numpy(),
                              "bias": gn.bias.detach().numpy()}}
    flax_out = torch.from_numpy(np.asarray(Norm().apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1))))).permute(0, 3, 1, 2).double()
    flax_err = float((flax_out - want).norm() / want.norm())
    assert float((got - flax_out).norm() / flax_out.norm()) <= flax_err + 1e-6


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vqgan_forward_matches_jax(ji, train):
    """recon, commit, ids, emb and (train mode) the codebook's EMA."""
    x = images()
    recon, commit, ids, emb, new_vq = ji.m.apply(ji.variables, jnp.asarray(x), ji.vq, train)
    t = port_vqgan(ji)
    t.train(train)
    with torch.no_grad():
        r, c, i, e = t(_nchw(x), train=train)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ids))
    assert i.dtype == torch.int32 and i.shape == (B, 8, 8)
    close(_nhwc(r), recon)
    close(_nhwc(e), emb)
    np.testing.assert_allclose(float(c), float(commit), rtol=1e-5)
    for got, want in zip(t.vq.state(), new_vq):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if not train:
        assert all(torch.equal(a, torch.from_numpy(np.asarray(b)))
                   for a, b in zip(t.vq.state(), ji.vq))


def test_generate_image_from_ids_matches_jax(ji):
    ids = np.random.default_rng(5).integers(0, KW["dict_size"], (B, 8, 8)).astype(np.int32)
    want = ji.m.apply(ji.variables, jnp.asarray(ids), ji.vq,
                      method=ji.m.generate_image_from_ids)
    t = port_vqgan(ji).eval()
    with torch.no_grad():
        got = t.generate_image_from_ids(torch.from_numpy(ids))
    close(_nhwc(got), want)


def test_reference_state_dict_loads_strict(ji):
    """The reference-named state dict the JAX package's export writes
    (`torch_export.export_vqgan`, the keys `import_vqgan` reads) loads into
    the port's VQGAN with `strict=True` and gives what the bridge gives."""
    ref = torch_export.export_vqgan(_np(ji.variables), _np(ji.vq), ji.m)
    t = tvqgan.VQGAN(**KW)
    t.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}, strict=True)
    want = port_vqgan(ji).state_dict()
    assert set(ref) == set(want)
    for k, v in t.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# ActNorm and the PatchGAN with it
# ---------------------------------------------------------------------------
def test_actnorm_matches_jax():
    """Eval before init, the first train batch's data init, a second batch
    (the statistics kept), reverse, logdet, a 2-D input."""
    rng = np.random.default_rng(6)
    x1 = (rng.normal(size=(2, 5, 6, 8)) * 3 + 2).astype(np.float32)
    x2 = rng.normal(size=(3, 4, 4, 8)).astype(np.float32)
    jm = JActNorm(8, logdet=True)
    variables = jm.init(jax.random.key(0), jnp.asarray(x1), train=False)
    params = {"loc": np.linspace(-0.2, 0.3, 8).astype(np.float32),
              "scale": np.linspace(0.5, 1.5, 8).astype(np.float32)}
    tm = ActNorm(8, logdet=True)
    with torch.no_grad():
        tm.loc.copy_(torch.from_numpy(params["loc"]).reshape(1, 8, 1, 1))
        tm.scale.copy_(torch.from_numpy(params["scale"]).reshape(1, 8, 1, 1))
    coll = variables["actnorm"]

    def both(x, train, reverse=False):
        nonlocal coll
        out, upd = jm.apply({"params": params, "actnorm": coll}, jnp.asarray(x), train=train,
                            reverse=reverse, mutable=["actnorm"])
        coll = upd["actnorm"]
        tm.train(train)
        with torch.no_grad():
            got = tm(_nchw(x) if x.ndim == 4 else torch.from_numpy(x), reverse=reverse)
        return out, got

    for x, train in ((x1, False), (x1, True), (x2, True), (x2, False)):
        (want, want_ld), (got, got_ld) = both(x, train)
        close(_nhwc(got), want)
        np.testing.assert_allclose(got_ld.numpy(), np.asarray(want_ld), rtol=1e-5)
        np.testing.assert_allclose(tm.data_loc.flatten().numpy(), np.asarray(coll["data_loc"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.data_scale.flatten().numpy(),
                                   np.asarray(coll["data_scale"]), rtol=1e-5, atol=1e-6)
        assert int(tm.initialized) == int(bool(coll["initialized"])) == int(train or x is x2)
    want, got = both(x2, False, reverse=True)
    close(_nhwc(got), want)
    flat = rng.normal(size=(4, 8)).astype(np.float32)
    (want, _), (got, _) = both(flat, False)
    close(got.numpy(), want)


def test_actnorm_loads_a_reference_state_dict():
    """A reference checkpoint stores loc, scale and initialized only: it
    loads with `strict=True`, the captured statistics neutral."""
    tm = ActNorm(4)
    tm.train()
    tm(torch.randn(2, 4, 3, 3) * 5)
    ref = {"loc": torch.full((1, 4, 1, 1), 0.5), "scale": torch.full((1, 4, 1, 1), 2.0),
           "initialized": torch.tensor(1, dtype=torch.uint8)}
    tm.load_state_dict(ref, strict=True)
    assert torch.equal(tm.data_loc, torch.zeros(1, 4, 1, 1))
    assert torch.equal(tm.data_scale, torch.ones(1, 4, 1, 1))
    x = torch.randn(2, 4, 3, 3)
    assert torch.allclose(tm.eval()(x), 2.0 * (x + 0.5))


def test_nlayer_discriminator_actnorm_matches_jax():
    """The PatchGAN with `normalization: "actnorm"` and spectral norm: two
    train-mode forwards (the first initialises each ActNorm), the weight
    gradients of the second, an eval forward; the ActNorm statistics and
    spectral-norm vectors after them."""
    rng = np.random.default_rng(7)
    x1, x2 = (rng.normal(size=(2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    jm = JNLayer(n_filters=8, n_layers=2, normalization="actnorm", apply_spectral_norm=True)
    variables = jax.jit(lambda k: jm.init(k, jnp.asarray(x1), train=False))(jax.random.key(9))
    tm = NLayerDiscriminator(n_filters=8, n_layers=2, normalization="actnorm",
                             apply_spectral_norm=True)
    tm.load_state_dict(bridge.from_jax_discriminator(_np(variables)), strict=True)
    params, extra = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    out1, extra = jm.apply({"params": params, **extra}, jnp.asarray(x1), True,
                           mutable=list(extra))

    def loss(p, extra):
        out, upd = jm.apply({"params": p, **extra}, jnp.asarray(x2), True, mutable=list(extra))
        return jnp.sum(out ** 2), (out, upd)

    (_, (out2, extra)), grads = jax.value_and_grad(loss, has_aux=True)(params, extra)
    out3 = jm.apply({"params": params, **extra}, jnp.asarray(x1), False)

    tm.train()
    with torch.no_grad():
        got1 = tm(_nchw(x1))
    got2 = tm(_nchw(x2))
    got2.pow(2).sum().backward()
    with torch.no_grad():
        got3 = tm.eval()(_nchw(x1))
    for got, want in ((got1, out1), (got2, out2), (got3, out3)):
        close(_nhwc(got), want)
    want_sd = bridge.from_jax_discriminator({"params": _np(grads), **_np(extra)})
    for k, p in tm.named_parameters():
        close(p.grad.numpy(), want_sd[k].numpy(), rtol=1e-4)
    want_sd = bridge.from_jax_discriminator({"params": _np(params), **_np(extra)})
    buffers = [k for k in want_sd if k.endswith(("data_loc", "data_scale", "initialized",
                                                 "weight_u"))]
    assert len([k for k in buffers if k.endswith("data_loc")]) == 2
    for k in buffers:
        np.testing.assert_allclose(tm.state_dict()[k].float().numpy(),
                                   want_sd[k].float().numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the VQGAN step
# ---------------------------------------------------------------------------
def _loss_cfgs(fs, ss, cfg):
    return ss.second_stage_config_from_json(cfg.loss), fs.loss_config_from_json(cfg.loss).w_commit


def run_jax(ji):
    """Two JAX steps from the initial state on two batches: ([s0, s1, s2]
    as numpy, [metrics_1, metrics_2], [rng_0, rng_1])."""
    jcfg = jload_json(CONFIG)
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    dis_tx = jstate.make_optimizer_from_config(jcfg.dis_optim)
    s = jstate.create_train_state(jax.random.key(4), {"params": {}}, ji.variables, ji.vq,
                                  jstate.make_optimizer_from_config(jcfg.enc_optim), dec_tx,
                                  dis_vars=ji.dis_vars, dis_tx=dis_tx)
    loss_cfg, w_commit = _loss_cfgs(jfs, jss, jcfg)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(j_make_vqgan_step(ji.m, ji.jdis, dec_tx, dis_tx, loss_cfg=loss_cfg,
                                         w_commit=w_commit))
        states, metrics, rngs = [s], [], []
        for seed in (21, 22):
            rngs.append(states[-1].rng)
            s, m = step(states[-1], jnp.asarray(images(seed)), 0.0)
            states.append(s)
            metrics.append({k: float(v) for k, v in m.items()})
    fields = ("enc_vars", "dec_vars", "vq", "dis_vars", "dec_opt", "dis_opt")
    return ([SimpleNamespace(**{f: _np(getattr(st, f)) for f in fields}) for st in states],
            metrics, rngs)


def port_state(s0):
    cfg = load_json(CONFIG)
    vqgan = tvqgan.VQGAN(**KW)
    dis = UNetDiscriminator(D_ch=4, D_attn="0", resolution=128)
    state = tstate.create_train_state(
        None, vqgan, None, tstate.make_optimizer_from_config(vqgan.parameters(), cfg.dec_optim),
        device="cpu", discriminator=dis,
        dis_opt=tstate.make_optimizer_from_config(dis.parameters(), cfg.dis_optim))
    return cfg, bridge.load_jax_train_state(state, s0)


@contextlib.contextmanager
def rounding_floor(seed=0):
    """Inside the block the VQGAN runs perturbed at the rounding level:
    PyTorch's native CPU convolutions instead of oneDNN's, and the
    quantized features moved by one ulp up or down at random."""
    gen = torch.Generator().manual_seed(seed)
    real = tvqgan.vq_apply

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        up = torch.randint(0, 2, q.shape, generator=gen).bool()
        moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
        return (q + (moved - q).detach(), *rest)

    tvqgan.vq_apply = nudged
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        tvqgan.vq_apply = real


def run_port(s0, draws, floor=False):
    """Two port steps from the JAX initial state with JAX's draws: the
    states' snapshots after each step, and each step's metrics."""
    cfg, state = port_state(s0)
    loss_cfg, w_commit = _loss_cfgs(tfs, tss, cfg)
    step = tvs.make_vqgan_step(state.decoder, state.discriminator, loss_cfg=loss_cfg,
                               w_commit=w_commit, device="cpu")
    snaps, metrics = [snapshot(state)], []
    with rounding_floor() if floor else contextlib.nullcontext():
        for seed, d in zip((21, 22), draws):
            state, m = step(state, images(seed), draws=d)
            snaps.append(snapshot(state))
            metrics.append({k: float(v) for k, v in m.items()})
    return snaps, metrics


def snapshot(state):
    """Copies of the modules' state dicts and Adam's first moments (under
    the modules' parameter names)."""
    out = {}
    for part in ("vqgan", "discriminator"):
        module, opt = getattr(state, SLOT[part]), getattr(state, OPT[part])
        out[part] = {k: v.clone() for k, v in module.state_dict().items()}
        out[part + "_mu"] = {k: opt.state[p]["exp_avg"].clone() if p in opt.state
                             else torch.zeros_like(p) for k, p in module.named_parameters()}
    return out


def jax_snapshot(s, module):
    """A JAX state as `snapshot` lays it out."""
    mu_dec = next(x for x in s.dec_opt if hasattr(x, "mu")).mu
    mu_dis = next(x for x in s.dis_opt if hasattr(x, "mu")).mu
    return {"vqgan": bridge.from_jax_vqgan(s.dec_vars, s.vq, module),
            "vqgan_mu": bridge.from_jax_vqgan({"params": mu_dec}, s.vq, module),
            "discriminator": bridge.from_jax_discriminator(s.dis_vars),
            "discriminator_mu": bridge.from_jax_discriminator({**s.dis_vars, "params": mu_dis})}


def eval_ids(module_sd, x):
    t = tvqgan.VQGAN(**KW)
    t.load_state_dict(module_sd, strict=True)
    with torch.no_grad():
        return t.eval()(_nchw(x), train=False)[2].numpy()


@pytest.fixture(scope="module")
def steps(ji):
    states, jm, rngs = run_jax(ji)
    draws = [jax_draws(rng, 1, SIZE, SIZE) for rng in rngs]
    shape = tvqgan.VQGAN(**KW)
    want = [jax_snapshot(s, shape) for s in states]
    port_snaps, port_m = run_port(states[0], draws)
    floor_snaps, floor_m = run_port(states[0], draws, floor=True)
    return SimpleNamespace(states=states, want=want, jm=jm, port=port_snaps, port_m=port_m,
                           floor=floor_snaps, floor_m=floor_m, params=shape)


def limit(floor):
    return max(5 * floor, BASE_RTOL)


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _cat(sd, names):
    return torch.cat([sd[k].flatten() for k in names])


def _param_names(steps, part):
    module = steps.params if part == "vqgan" else UNetDiscriminator(D_ch=4, D_attn="0",
                                                                    resolution=128)
    return sorted(k for k, _ in module.named_parameters())


def test_step_ids_held_first(ji, steps):
    """The eval-forward ids of the port equal JAX's on the start and on
    JAX's state after step 1, for both batches: no id sits at a near tie
    that the two frameworks' rounding could flip."""
    for i in (0, 1):
        for seed in (21, 22):
            x = images(seed)
            want = np.asarray(ji.m.apply(steps.states[i].dec_vars, jnp.asarray(x),
                                         steps.states[i].vq, False)[2])
            np.testing.assert_array_equal(eval_ids(steps.want[i]["vqgan"], x), want)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", METRICS)
def test_step_losses_match_jax(steps, n, name):
    got, want, floor = steps.port_m[n - 1], steps.jm[n - 1], steps.floor_m[n - 1]
    assert set(got) == set(want) == set(METRICS)
    tol = limit(abs(floor[name] - got[name]) / max(abs(got[name]), 1e-12))
    atol = 1e-6 if name == "consistency" else 0.0
    assert abs(got[name] - want[name]) <= atol + tol * abs(want[name]), (
        name, got[name], want[name], floor[name])
    if name == "perceptual":
        assert got[name] == 0.0


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("part", ["vqgan", "discriminator"])
def test_step_gradients_match_jax(steps, n, part):
    """Adam's first moment after n steps ((1 − β1)·g after one)."""
    names = _param_names(steps, part)
    got = _cat(steps.port[n][part + "_mu"], names)
    want = _cat(steps.want[n][part + "_mu"], names)
    floor = _rel(_cat(steps.floor[n][part + "_mu"], names), got)
    assert _rel(got, want) <= limit(floor), (part, _rel(got, want), floor)


def _mismatch(d, ref, lr):
    return float(((d - ref).abs() > 1e-3 * lr).float().mean())


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("part", ["vqgan", "discriminator"])
def test_step_parameter_updates_match_jax(steps, n, part):
    names = _param_names(steps, part)
    lr = 1e-4 if part == "vqgan" else 4e-4
    start = _cat(steps.port[0][part], names)
    got = _cat(steps.port[n][part], names) - start
    want = _cat(steps.want[n][part], names) - start
    floor = _cat(steps.floor[n][part], names) - start
    err, ref = _mismatch(got, want, lr), _mismatch(floor, got, lr)
    assert err <= max(5 * ref, MAX_MISMATCH), (part, err, ref)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("n", [1, 2])
def test_step_codebook_and_spectral_norm_match_jax(steps, n):
    """The codebook's EMA buffers (which moved) and the spectral-norm
    vectors (advanced once per train-mode forward, in JAX's order)."""
    for part, keys in (("vqgan", ("vq.embed", "vq.cluster_size", "vq.embed_avg")),
                       ("discriminator", [k for k in steps.port[n]["discriminator"]
                                          if k.endswith(("u0", "sv0"))])):
        assert keys
        for k in keys:
            got, want = steps.port[n][part][k], steps.want[n][part][k]
            floor = float((steps.floor[n][part][k] - got).abs().max()) / max(
                float(got.abs().max()), 1e-12)
            tol = limit(floor)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=1e-6 + tol,
                                       err_msg=k)
    assert not torch.equal(steps.port[n]["vqgan"]["vq.cluster_size"],
                           steps.port[0]["vqgan"]["vq.cluster_size"])


def test_step_draws_from_the_state_generator(ji):
    """Without draws the step takes its (box, invert) from
    `state.generator`: two states seeded alike step alike, and the
    generator moves; the discriminator's parameters come out of the
    generator pass with `requires_grad` on."""
    s0 = SimpleNamespace(dec_vars=_np(ji.variables), vq=_np(ji.vq), dis_vars=_np(ji.dis_vars))
    results = []
    for _ in range(2):
        cfg, state = port_state(s0)
        loss_cfg, w_commit = _loss_cfgs(tfs, tss, cfg)
        step = tvs.make_vqgan_step(state.decoder, state.discriminator, loss_cfg=loss_cfg,
                                   w_commit=w_commit, device="cpu")
        g0 = state.generator.get_state().clone()
        _, metrics = step(state, images())
        assert not torch.equal(g0, state.generator.get_state())
        assert all(p.requires_grad for p in state.discriminator.parameters())
        assert state.step == 1 and state.encoder is None
        results.append({k: float(v) for k, v in metrics.items()})
    assert results[0] == results[1]


def test_step_dropout_draws_from_the_state_generator(ji):
    """With `p_dropout` > 0 the masks come from `state.generator`: two
    states seeded alike step alike, and unlike a step without dropout."""
    s0 = SimpleNamespace(dec_vars=_np(ji.variables), vq=_np(ji.vq), dis_vars=_np(ji.dis_vars))
    results = []
    for p in (0.3, 0.3, 0.0):
        cfg, state = port_state(s0)
        for m in state.decoder.modules():
            if isinstance(m, tvqgan.ResnetBlock):
                m.p_dropout = p
        loss_cfg, w_commit = _loss_cfgs(tfs, tss, cfg)
        step = tvs.make_vqgan_step(state.decoder, state.discriminator, loss_cfg=loss_cfg,
                                   w_commit=w_commit, device="cpu")
        _, metrics = step(state, images(), draws=tss.sample_cutmix_draws(
            torch.Generator().manual_seed(0), 1, SIZE, SIZE))
        results.append(float(metrics["recon"]))
    assert results[0] == results[1] != results[2]


def test_step_refuses_the_patchgan():
    vqgan = tvqgan.VQGAN(**KW)
    with pytest.raises(ValueError, match="UNetDiscriminator"):
        tvs.make_vqgan_step(vqgan, NLayerDiscriminator(n_filters=4, n_layers=1),
                            loss_cfg=tss.SecondStageLossConfig(), device="cpu")
