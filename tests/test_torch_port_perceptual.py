"""The port's perceptual losses (VGG19 feature MSE, LPIPS) and segmentation
losses against the JAX package's, on the CPU.

The same numpy inputs from a seed go to both sides, in f32: the VGG at
32², LPIPS at 64² (AlexNet's stride-4 stem needs the room), batch 2, one
channel (repeated to three by both). Pretrained-format npz files are
fabricated in a tmp dir (He-scaled normal weights, so activations stay of
order 1 through the stack) and named by `MEDIMG_VGG19_NPZ` /
`MEDIMG_LPIPS_NPZ`; the fallbacks draw from different streams in the two
frameworks, so the JAX fallback's parameters are carried across
(`utils/weights.py::from_jax_perceptual`). Tolerances: losses rtol 1e-5,
their gradients with respect to `pred` atol 1e-4 × the largest gradient
(the same convolutions summed in other orders); the segmentation losses
rtol 1e-5.

The VQGAN step with the VGG loss on (weight 1, the fallback's weights
carried across) is held to the JAX step as tests/test_torch_port_vqgan.py
holds it without: at that file's sizes, from the same variables and CutMix
draws, every loss and each module's gradient (Adam's first moment,
relative Frobenius norm) within max(5 × floor, 1e-4) relative, the floor
the port's own step perturbed at the rounding level (that file's
`rounding_floor`). The JAX step is compiled once (module fixture), with
the `xla` VQ backend.
"""

import contextlib
import json
import math
import os
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import vqgan as jvqgan
from medical_image_editing_tpu.ops import losses as jl
from medical_image_editing_tpu.ops import perceptual as jp
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import second_stage as jss
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.train.vqgan_stage import make_vqgan_step as j_make_vqgan_step
from medical_image_editing_tpu.utils.config import to_config as j_to_config
from medical_image_editing_tpu_torch.models import vqgan as tvqgan
from medical_image_editing_tpu_torch.models.unet_discriminator import UNetDiscriminator
from medical_image_editing_tpu_torch.ops import losses as tl
from medical_image_editing_tpu_torch.ops import perceptual as tp
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import second_stage as tss
from medical_image_editing_tpu_torch.train import vqgan_stage as tvs
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.config import to_config
from test_torch_port_second_stage import jax_draws
from test_torch_port_vqgan import KW, METRICS, SIZE, ji, images, port_state, rounding_floor

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4  # × max |grad|
LPIPS_KEYS = ["net.slice1.0", "net.slice2.3", "net.slice3.6", "net.slice4.8", "net.slice5.10"]


@pytest.fixture(autouse=True)
def no_weights(monkeypatch):
    monkeypatch.delenv("MEDIMG_VGG19_NPZ", raising=False)
    monkeypatch.delenv("MEDIMG_LPIPS_NPZ", raising=False)


def _he(rng, cout, cin, k):
    return (rng.normal(size=(cout, cin, k, k)) * math.sqrt(2.0 / (cin * k * k))).astype(np.float32)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """torchvision VGG19 `features` and lpips(alex) state dicts, as npz."""
    root = tmp_path_factory.mktemp("perceptual")
    rng = np.random.default_rng(7)
    vgg, cin = {}, 3
    for i, cout in tp._VGG19_CHANNELS.items():
        vgg[f"features.{i}.weight"] = _he(rng, cout, cin, 3)
        vgg[f"features.{i}.bias"] = rng.normal(size=cout).astype(np.float32) * 0.1
        cin = cout
    np.savez(root / "vgg19.npz", **vgg)
    lpips, cin = {}, 3
    for key, (cout, k, _, _, _) in zip(LPIPS_KEYS, tp._ALEX_CONVS):
        lpips[f"{key}.weight"] = _he(rng, cout, cin, k)
        lpips[f"{key}.bias"] = rng.normal(size=cout).astype(np.float32) * 0.1
        cin = cout
    for i, (cout, *_) in enumerate(tp._ALEX_CONVS):
        lpips[f"lin{i}.model.1.weight"] = rng.uniform(
            0, 0.1, size=(1, cout, 1, 1)).astype(np.float32)
    np.savez(root / "lpips.npz", **lpips)
    bad = {k: v for k, v in lpips.items() if not k.startswith("lin")}
    np.savez(root / "bad_lpips.npz", **bad)
    return root


def _images(size, seed=0, b=2):
    rng = np.random.default_rng(seed)
    pred = np.tanh(rng.normal(size=(b, size, size, 1))).astype(np.float32)
    target = np.tanh(rng.normal(size=(b, size, size, 1))).astype(np.float32)
    return pred, target


def _jax_value_grad(fn, pred, target):
    val, grad = jax.value_and_grad(fn)(jnp.asarray(pred), jnp.asarray(target))
    return float(val), np.asarray(grad)


def _port_value_grad(module, pred, target):
    p = torch.tensor(pred).permute(0, 3, 1, 2).requires_grad_(True)
    t = torch.tensor(target).permute(0, 3, 1, 2)
    val = module(p, t)
    (grad,) = torch.autograd.grad(val, p)
    return float(val.detach()), grad.permute(0, 2, 3, 1).numpy()


def _assert_match(port, jax_, what):
    (pv, pg), (jv, jg) = port, jax_
    np.testing.assert_allclose(pv, jv, rtol=LOSS_RTOL, err_msg=what)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(pg, jg, atol=GRAD_ATOL * np.abs(jg).max(), rtol=0, err_msg=what)


@pytest.mark.parametrize("conv_index", ["22", "54"])
def test_vgg_pretrained_matches_jax(npz, monkeypatch, conv_index):
    monkeypatch.setenv("MEDIMG_VGG19_NPZ", str(npz / "vgg19.npz"))
    pred, target = _images(32)
    jfn = jp.make_vgg_loss(conv_index)
    port = tp.make_vgg_loss(conv_index, device="cpu")
    assert port.pretrained and jfn.pretrained
    assert not any(True for _ in port.parameters())
    _assert_match(_port_value_grad(port, pred, target), _jax_value_grad(jfn, pred, target),
                  f"vgg {conv_index}")


def test_lpips_pretrained_matches_jax(npz, monkeypatch):
    monkeypatch.setenv("MEDIMG_LPIPS_NPZ", str(npz / "lpips.npz"))
    pred, target = _images(64, seed=1)
    jfn = jp.make_lpips_loss()
    port = tp.make_perceptual_loss("lpips", device="cpu")
    assert port.pretrained and jfn.pretrained
    _assert_match(_port_value_grad(port, pred, target), _jax_value_grad(jfn, pred, target),
                  "lpips")


def _jax_fallback_params(kind):
    with pytest.warns(UserWarning, match="No pretrained"):
        if kind == "lpips":
            convs, lins, _ = jp._load_lpips_alex_params()
            return convs, lins
        return jp._load_vgg_params({"vgg22": 8, "vgg54": 35}[kind])


@pytest.mark.parametrize("kind", ["vgg22", "vgg54", "lpips"])
def test_fallback_matches_jax_with_carried_params(kind):
    size = 64 if kind == "lpips" else 32
    pred, target = _images(size, seed=2)
    with pytest.warns(UserWarning, match="No pretrained"):
        jfn = jp.make_lpips_loss() if kind == "lpips" else jp.make_vgg_loss(kind[3:])
    with pytest.warns(UserWarning, match="No pretrained"):
        port = (tp.make_lpips_loss(device="cpu") if kind == "lpips"
                else tp.make_vgg_loss(kind[3:], device="cpu"))
    assert not port.pretrained and not jfn.pretrained
    port.load_state_dict(bridge.from_jax_perceptual(_jax_fallback_params(kind)), strict=True)
    _assert_match(_port_value_grad(port, pred, target), _jax_value_grad(jfn, pred, target),
                  f"{kind} fallback")


@pytest.mark.parametrize("kind", ["vgg", "lpips"])
def test_fallback_draw_matches_jax_distribution(kind):
    """Shapes as JAX's fallback (OIHW of its HWIO), he-normal truncated at
    ±2σ (σ = √(2/fan_in)/0.8796), std within 5% of √(2/fan_in), zero
    biases, uniform 1/C LPIPS heads; seeded, so two builds are equal."""
    with pytest.warns(UserWarning, match="No pretrained"):
        port = tp.make_perceptual_loss(kind, device="cpu")
    with pytest.warns(UserWarning, match="No pretrained"):
        again = tp.make_perceptual_loss(kind, device="cpu")
    want = bridge.from_jax_perceptual(
        _jax_fallback_params("lpips" if kind == "lpips" else "vgg22"))
    got = port.state_dict()
    assert got.keys() == want.keys()
    for key, value in got.items():
        assert value.shape == want[key].shape, key
        assert torch.equal(value, again.state_dict()[key]), key
        if key.endswith("bias"):
            assert not value.any(), key
        elif key.startswith("lin"):
            assert torch.all(value == 1.0 / value.numel()), key
        else:
            target_std = math.sqrt(2.0 / value[0].numel())
            assert value.abs().max() <= 2.0 * target_std / 0.87962566103423978 * (1 + 1e-6)
            assert abs(float(value.std()) / target_std - 1.0) < 0.05, key


def test_malformed_lpips_npz_raises(npz, monkeypatch):
    monkeypatch.setenv("MEDIMG_LPIPS_NPZ", str(npz / "bad_lpips.npz"))
    with pytest.raises(ValueError, match="is not an lpips state_dict npz") as port_err:
        tp.make_lpips_loss(device="cpu")
    with pytest.raises(ValueError, match="is not an lpips state_dict npz") as jax_err:
        jp.make_lpips_loss()
    assert str(port_err.value) == str(jax_err.value)


def test_make_perceptual_loss_kinds(npz, monkeypatch):
    monkeypatch.setenv("MEDIMG_VGG19_NPZ", str(npz / "vgg19.npz"))
    vgg = tp.make_perceptual_loss("vgg", device="cpu")
    assert isinstance(vgg, tp.VGGLoss) and vgg.stop_index == 8 and vgg.pretrained
    assert sorted(vgg.state_dict()) == sorted(
        f"features.{i}.{p}" for i in (0, 2, 5, 7) for p in ("weight", "bias"))
    with pytest.raises(ValueError, match="unknown perceptual_loss_type 'alex'"):
        tp.make_perceptual_loss("alex", device="cpu")
    with pytest.raises(ValueError, match="unknown perceptual_loss_type 'alex'"):
        jp.make_perceptual_loss("alex")


def test_bf16_input_runs_in_f32(npz, monkeypatch):
    """A bf16 prediction is cast to f32 first, as JAX's `astype(float32)`."""
    monkeypatch.setenv("MEDIMG_VGG19_NPZ", str(npz / "vgg19.npz"))
    pred, target = _images(32, seed=3)
    port = tp.make_vgg_loss("22", device="cpu")
    p16 = torch.tensor(pred).permute(0, 3, 1, 2).bfloat16()
    t = torch.tensor(target).permute(0, 3, 1, 2)
    got = port(p16, t)
    assert got.dtype == torch.float32
    want = jp.make_vgg_loss("22")(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind", ["vgg", "lpips"])
def test_from_jax_perceptual_round_trip(kind):
    """JAX parameters → the port's buffers → back to HWIO: equal, and the
    port's module loads them strictly."""
    params = _jax_fallback_params("lpips" if kind == "lpips" else "vgg22")
    sd = bridge.from_jax_perceptual(params)
    if kind == "lpips":
        convs, lins = params
        back = ([(sd[f"convs.{k}.weight"].numpy().transpose(2, 3, 1, 0),
                  sd[f"convs.{k}.bias"].numpy()) for k in range(len(convs))],
                [sd[f"lin{k}"].numpy() for k in range(len(lins))])
        pairs = list(zip(convs, back[0])) + [((a,), (b,)) for a, b in zip(lins, back[1])]
    else:
        pairs = [(params[i], (sd[f"features.{i}.weight"].numpy().transpose(2, 3, 1, 0),
                              sd[f"features.{i}.bias"].numpy())) for i in params]
    for want, got in pairs:
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.warns(UserWarning, match="No pretrained"):
        module = tp.make_perceptual_loss(kind, device="cpu")
    module.load_state_dict(sd, strict=True)


def _seg_inputs(seed=0, b=2, h=5, w=6, k=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w, k)).astype(np.float32) * 2.0
    target = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=(b, h, w))]
    return logits, target


@pytest.mark.parametrize("case", ["dice", "dice_ignore", "dice_smooth", "focal", "focal_gamma"])
def test_segmentation_losses_match_jax(case):
    logits, target = _seg_inputs()
    if case == "dice_smooth":  # every class ignored: the denominator's floor
        logits, target = logits[..., :1], target[..., :1]
    name = "focal_loss" if case.startswith("focal") else "soft_dice_loss"
    kw = {"dice_ignore": {"ignore_index": 0}, "dice_smooth": {"ignore_index": 0, "smooth": 0.5},
          "focal_gamma": {"gamma": 0.5}}.get(case, {})
    got = getattr(tl, name)(torch.tensor(logits), torch.tensor(target), **kw)
    want = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(target), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the VQGAN step with the VGG loss on
# ---------------------------------------------------------------------------
def _vqgan_config():
    cfg = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                                      "crc_vqgan.json")))
    cfg["loss"].update(use_perceptual_loss=True, perceptual_loss_type="vgg")
    cfg["loss"]["loss_weight"]["perceptual"] = 1.0
    return cfg


def _vgg_pair():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jfn, params = jp.make_vgg_loss("22"), jp._load_vgg_params(8)
        port = tp.make_vgg_loss("22", device="cpu")
    port.load_state_dict(bridge.from_jax_perceptual(params), strict=True)
    return jfn, port


def _vqgan_port(s0, raw, vgg, image, draws, floor=False):
    _, state = port_state(s0)
    cfg = to_config(raw)
    step = tvs.make_vqgan_step(state.decoder, state.discriminator,
                               loss_cfg=tss.second_stage_config_from_json(cfg.loss),
                               w_commit=tfs.loss_config_from_json(cfg.loss).w_commit,
                               perceptual_fn=vgg, device="cpu")
    with rounding_floor() if floor else contextlib.nullcontext():
        state, m = step(state, image, draws=draws)
    mu = {part: {k: opt.state[p]["exp_avg"].numpy() for k, p in module.named_parameters()}
          for part, module, opt in (("vqgan", state.decoder, state.dec_opt),
                                    ("discriminator", state.discriminator, state.dis_opt))}
    return SimpleNamespace(metrics={k: float(v) for k, v in m.items()}, mu=mu)


@pytest.fixture(scope="module")
def vqgan_step(ji):
    raw = _vqgan_config()
    jcfg = j_to_config(raw)
    jfn, port_vgg = _vgg_pair()
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    dis_tx = jstate.make_optimizer_from_config(jcfg.dis_optim)
    s0 = jstate.create_train_state(jax.random.key(4), {"params": {}}, ji.variables, ji.vq,
                                   jstate.make_optimizer_from_config(jcfg.enc_optim), dec_tx,
                                   dis_vars=ji.dis_vars, dis_tx=dis_tx)
    module = jvqgan.VQGAN(**{**KW, "knn_backend": "xla"})
    image = images(21)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(j_make_vqgan_step(
            module, ji.jdis, dec_tx, dis_tx,
            loss_cfg=jss.second_stage_config_from_json(jcfg.loss),
            w_commit=jfs.loss_config_from_json(jcfg.loss).w_commit, perceptual_fn=jfn))
        s1, jm = step(s0, jnp.asarray(image), 0.0)
    fields = ("enc_vars", "dec_vars", "vq", "dis_vars", "dec_opt", "dis_opt")
    s0n = SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(s0, f)) for f in fields})
    mu_dec = next(x for x in s1.dec_opt if hasattr(x, "mu")).mu
    mu_dis = next(x for x in s1.dis_opt if hasattr(x, "mu")).mu
    shape = tvqgan.VQGAN(**KW)
    dis_names = {k for k, _ in UNetDiscriminator(D_ch=4, D_attn="0",
                                                 resolution=128).named_parameters()}
    want = {"vqgan": bridge.from_jax_vqgan({"params": jax.tree.map(np.asarray, mu_dec)},
                                           jax.tree.map(np.asarray, s1.vq), shape),
            "discriminator": {k: v for k, v in bridge.from_jax_discriminator(
                {**jax.tree.map(np.asarray, s1.dis_vars),
                 "params": jax.tree.map(np.asarray, mu_dis)}).items() if k in dis_names}}
    draws = jax_draws(s0.rng, 1, SIZE, SIZE)
    port = _vqgan_port(s0n, raw, port_vgg, image, draws)
    floor = _vqgan_port(s0n, raw, port_vgg, image, draws, floor=True)
    return SimpleNamespace(jm={k: float(v) for k, v in jm.items()}, want=want, port=port,
                           floor=floor)


def _limit(floor):
    return max(5 * floor, 1e-4)


@pytest.mark.parametrize("name", METRICS)
def test_vqgan_step_with_vgg_losses_match_jax(vqgan_step, name):
    got, want, floor = (vqgan_step.port.metrics[name], vqgan_step.jm[name],
                        vqgan_step.floor.metrics[name])
    if name == "perceptual":
        assert want > 0
    tol = _limit(abs(floor - got) / max(abs(got), 1e-12))
    atol = 1e-6 if name == "consistency" else 0.0
    assert abs(got - want) <= atol + tol * abs(want), (name, got, want, floor)


@pytest.mark.parametrize("part", ["vqgan", "discriminator"])
def test_vqgan_step_with_vgg_gradients_match_jax(vqgan_step, part):
    want = vqgan_step.want[part]
    names = sorted(vqgan_step.port.mu[part])
    assert names == sorted(k for k in want if k in vqgan_step.port.mu[part])

    def cat(d):
        return np.concatenate([np.asarray(d[k]).ravel() for k in names])

    got, ref, fl = cat(vqgan_step.port.mu[part]), cat(want), cat(vqgan_step.floor.mu[part])
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    floor = np.linalg.norm(fl - got) / np.linalg.norm(got)
    assert err <= _limit(floor), (part, err, floor)
