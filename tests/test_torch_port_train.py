"""The first-stage training slice, port vs JAX package, end to end at small
size on the CPU: `init_codebook_step` then one `make_first_stage_step`,
both with `MEDIMG_CONV_IMPL=packed` (the JAX side runs its Pallas conv in
interpret mode) and `knn_backend="pallas"`, in float32.

Both sides start from the same flax-initialised variables (through the
port's weight bridge) and use the same random numbers: the test replays the
JAX step's key splits (`first_stage.py:106`, `augment.py:78,163,227`,
`kmeans.py:36`) into the port's draws and k-means start rows. The JAX step
is compiled and run once per file (module fixture), on both of its conv
routes: about two minutes on a one-core host.

Tolerances, all float32:
* losses, the codebook after k-means and the VQ EMA state: rtol 1e-4. The
  frameworks sum convolutions in other orders and the port's InstanceNorm
  is the two-pass form: the features agree to ~1e-6 and no VQ id differs
  (the losses would move by ~1e-4 if one did). The distance loss is atol
  1e-3: its pair sum keeps the diagonal, where ‖c‖² + ‖c‖² − 2c·c is a
  rounding residue whose square root (~1e-3) enters the hinge.
* BatchNorm running stats: rtol 1e-4, atol 1e-6.
* gradients and one-step parameter deltas, measured against the noise
  floor of the JAX step itself. At these toy sizes (2×2 bottlenecks, a
  piecewise-constant quantized decoder input) the reconstruction term's
  gradient through the straight-through estimator is ill-conditioned: the
  JAX step's two conv routes (`packed` and `xla`), which compute the same
  function and differ only in the summation order of 9 convolutions,
  disagree by ~4% in encoder gradients and ~0.2% in decoder gradients
  (relative Frobenius norm over all parameters). The port, which differs
  from JAX in every convolution and norm, must stay within 5× that floor;
  Adam's first step, −lr·g/(|g| + 1e-8), is ±lr wherever |g| ≫ 1e-8, and
  the fraction of parameters whose step differs must stay within 5× the
  fraction that differs between the two JAX routes.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.utils.config import load_json as jload_json
from medical_image_editing_tpu_torch.models import UNetDecoder
from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.config import load_json
from test_torch_port_augment import jax_view_draws, to_torch_draws

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_first_stage.json")
ENC = (4, 8, 16, 32, 64)
DEC = (32, 8, 8, 16, 16)  # level 0 at 32 channels: 9 decoder convs route to the kernel
DICT = 10
B, SIZE = 2, 32


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
    """The arrays of a JAX TrainState as numpy (the PRNG key left out)."""
    return SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                              for f in ("enc_vars", "dec_vars", "vq", "enc_opt", "dec_opt")})


@pytest.fixture(scope="module")
def run():
    """Both sides: init → codebook init → one step."""
    cfg = load_json(CONFIG)
    jcfg = jload_json(CONFIG)
    gen = jcfg.model.vqmodel
    image = _images()

    jenc = JEncoder(filters=ENC, dict_size=DICT, momentum=float(gen.momentum),
                    knn_backend="pallas")
    jdec = JDecoder(out_channels=1, filters=DEC, dropped_skip_layers=(),
                    use_pixel_shuffle=False)
    enc_vars, vq = jenc.init(jax.random.key(1), jnp.zeros((1, SIZE, SIZE, 1)))
    dec_vars = dict(jdec.init({"params": jax.random.key(2), "dropblock": jax.random.key(3)},
                              jnp.zeros((1, SIZE, SIZE, ENC[0])), train=False))
    enc_tx = jstate.make_optimizer_from_config(jcfg.enc_optim)
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    s0 = jstate.create_train_state(jax.random.key(4), enc_vars, dec_vars, vq, enc_tx, dec_tx)

    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = "packed"
    try:
        with jax.default_matmul_precision("highest"):
            s1 = jax.jit(jfs.init_codebook_step(jenc))(s0, jnp.asarray(image))
            def step():  # a new function for each route: jit caches by function
                return jax.jit(jfs.make_first_stage_step(
                    jenc, jdec, enc_tx, dec_tx, loss_cfg=jfs.loss_config_from_json(jcfg.loss),
                    aug_cfg=jcfg.augmentation, dict_size=DICT))

            s2, jmetrics = step()(s1, jnp.asarray(image))
            os.environ["MEDIMG_CONV_IMPL"] = "xla"
            s2_xla, _ = step()(s1, jnp.asarray(image))
            os.environ["MEDIMG_CONV_IMPL"] = "packed"

        # the port, from the same state and the same draws
        _, k_init = jax.random.split(s0.rng)
        init_idx = np.asarray(jax.random.choice(k_init, B * SIZE * SIZE, (DICT,),
                                                replace=False))
        _, k1, k2, _, _ = jax.random.split(s1.rng, 5)
        draws = tuple(to_torch_draws(jax_view_draws(k, jcfg.augmentation, B, SIZE, SIZE))
                      for k in (k1, k2))
        enc = EncoderWithVQ(1, ENC, DICT, momentum=float(gen.momentum),
                            knn_backend="pallas")
        dec = UNetDecoder(ENC[0], 1, DEC, dropped_skip_layers=(), use_pixel_shuffle=False)
        sds = bridge.from_jax_train_state(_np(s0))
        enc.load_state_dict(sds["encoder"], strict=True)
        dec.load_state_dict(sds["decoder"], strict=True)
        state = tstate.create_train_state(
            enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
            tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim),
            device="cpu")
        tfs.init_codebook_step(enc)(state, image, init_idx=torch.from_numpy(init_idx.copy()))
        vq_init = tuple(t.clone() for t in state.vq)
        before = {"encoder": {k: v.clone() for k, v in enc.state_dict().items()},
                  "decoder": {k: v.clone() for k, v in dec.state_dict().items()}}
        tstep = tfs.make_first_stage_step(enc, dec, loss_cfg=tfs.loss_config_from_json(cfg.loss),
                                          aug_cfg=cfg.augmentation, dict_size=DICT,
                                          device="cpu")
        state, metrics = tstep(state, image, draws=draws)
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL")
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev
    return dict(s0=_np(s0), s1=_np(s1), s2=_np(s2), s2_xla=_np(s2_xla),
                jmetrics=jax.tree.map(np.asarray, jmetrics), state=state, metrics=metrics,
                vq_init=vq_init, before=before)


def _port_grads(opt, module):
    """Adam's first moment after one step is 0.1·g → {key: g}."""
    names = {id(p): k for k, p in module.named_parameters()}
    b1 = opt.param_groups[0]["betas"][0]
    return {names[id(p)]: s["exp_avg"] / (1 - b1) for p, s in opt.state.items()}


def _jax_grads(s2, side, b1=0.9):
    """optax's first moment after one step is (1 − b1)·g → {port key: g},
    parameters only."""
    g = jax.tree.map(lambda m: m / (1 - b1), getattr(s2, f"{side}_opt")[0].mu)
    if side == "enc":
        return bridge.from_jax_encoder({"params": g})
    sd = bridge.from_jax_decoder({"params": g, "batch_stats": s2.dec_vars["batch_stats"]})
    return {k: v for k, v in sd.items() if "param_free_norm" not in k}


def test_codebook_init_matches_jax(run):
    for got, want in zip(run["vq_init"], run["s1"].vq):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["total", "commit", "cross", "dist", "reg", "recon",
                                  "freq", "perceptual"])
def test_step_losses_match_jax(run, name):
    np.testing.assert_allclose(float(run["metrics"][name]), float(run["jmetrics"][name]),
                               rtol=1e-4, atol=1e-3 if name == "dist" else 1e-7)


def test_step_vq_state_matches_jax(run):
    for got, want in zip(run["state"].vq, run["s2"].vq):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_step_batch_stats_match_jax(run):
    want = bridge.from_jax_decoder(run["s2"].dec_vars)
    got = run["state"].decoder.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 2 * (len(DEC) - 1)  # 2 norms × (mean, var) per level
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _disagreement(got, want):
    """Relative Frobenius norm of the difference over all parameters."""
    num = sum(float(np.sum((np.asarray(got[k]) - np.asarray(want[k])) ** 2)) for k in want)
    return np.sqrt(num / sum(float(np.sum(np.asarray(want[k]) ** 2)) for k in want))


def _deltas(params, before, keys):
    return {k: params[k].numpy() - before[k].numpy() for k in keys}


def _jax_params(s2, side):
    return (bridge.from_jax_encoder(s2.enc_vars) if side == "enc"
            else bridge.from_jax_decoder(s2.dec_vars))


def _step_mismatch(got, want, lr):
    """Fraction of parameters whose one-step update differs by > 1e-3·lr."""
    return (sum(int(np.sum(np.abs(got[k] - want[k]) > 1e-3 * lr)) for k in want)
            / sum(want[k].size for k in want))


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_step_gradients_match_jax(run, side):
    module = run["state"].encoder if side == "enc" else run["state"].decoder
    got = _port_grads(getattr(run["state"], f"{side}_opt"), module)
    want = _jax_grads(run["s2"], side)
    assert sorted(got) == sorted(want)
    floor = _disagreement(_jax_grads(run["s2_xla"], side), want)
    assert 0 < floor < 0.1
    assert _disagreement({k: g.numpy() for k, g in got.items()}, want) <= 5 * floor


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_step_parameter_deltas_match_jax(run, side):
    name = "encoder" if side == "enc" else "decoder"
    lr = getattr(run["state"], f"{side}_opt").param_groups[0]["lr"]
    before = run["before"][name]
    module = getattr(run["state"], name)
    keys = [k for k, _ in module.named_parameters()]
    got = _deltas(module.state_dict(), before, keys)
    want = _deltas(_jax_params(run["s2"], side), before, keys)
    floor = _step_mismatch(_deltas(_jax_params(run["s2_xla"], side), before, keys), want, lr)
    assert max(np.abs(d).max() for d in got.values()) <= lr * (1 + 1e-3)
    assert _step_mismatch(got, want, lr) <= 5 * max(floor, 1e-3)
