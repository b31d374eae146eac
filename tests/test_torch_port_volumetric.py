"""The volumetric VQ-WNet, port vs JAX package, on the CPU at the JAX
package's own test sizes (`tests/test_volumetric.py`): filters (4, 8, 16),
`dict_size` 5, 16³ and a non-cubic 8×16×24 volume (a scrambled voxel order
in the VQ rows would land ids in the wrong voxels there), batch 2.

Both sides start from the same flax-initialised variables (carried by
`utils/weights.py::from_jax_volumetric`); the JAX inits and steps are
compiled once per file (module fixtures).

Tolerances, float32 (readings on this suite's CPU host at the end):
* blocks and instance norm: rtol 1e-5, atol 1e-5 × the output's largest
  magnitude (XLA's and oneDNN's convolutions sum in other orders);
* the forward: the ids exactly wherever the top-2 score gap is clear of
  rounding (> 1e-5·max|score|; every id at these seeds), the commit loss
  and the EMA state rtol 1e-5, the reconstruction atol 1e-4 (instance
  norm divides the convolutions' rounding residue by the channel's
  standard deviation);
* the steps (two, f32): every quantity within min(max(5 × floor, 1e-4),
  0.5) (relative; the cap below the 1.0 a zero gradient or update reads),
  the floor measured in the same run as the port's own steps
  perturbed at the rounding level: PyTorch's native CPU convolutions
  instead of oneDNN's, and the quantized features moved by one ulp up or
  down at random (the gradient still flows straight through). Losses;
  gradients read from Adam's first moment (relative Frobenius norm over
  each module's parameters); the parameter updates (relative Frobenius
  norm), and after the first step the fraction of elements whose update
  differs by more than 1e-3·lr (Adam's first step is ±lr wherever
  |g| ≫ 1e-8, so an element at its sum's rounding level can turn) within
  min(max(5 × the floor's fraction, 1e-3), 0.5); the codebook's buffers
  elementwise with atol 1e-6 + the limit. The encoder's limits reach the
  cap: its gradient at these widths moves 5-10% under rounding-level
  perturbations, so there the checks catch gross faults only;
* remat against plain: bit for bit (the same operations recomputed);
* bf16 with remat (the JAX package's 128³ memory plan) against JAX's bf16
  step on two structured 32³ volumes: the losses rtol 2⁻⁷ (two bf16
  ulps), the codebook rtol 2⁻⁶, the weight gradients of each module's
  last up block directly against JAX's bf16 ones within 0.3, the head's
  weight gradient 2⁻⁵ and its bias 2⁻⁵ of JAX's f32 one; each module's
  weights together within 1.5× JAX's own bf16-to-f32 distance, at most
  0.9 (the test's docstring says why);
* the edit function: atol 1e-4 of the decode, uint8 within one level (a
  truncating cast of values that differ at rounding level).

The second step starts, on the port's side, from JAX's state after the
first (parameters, Adam's moments and count, the codebook): Adam's first
step is ±lr wherever |g| ≫ 1e-8, and the encoder's gradient at these
widths moves by 5-10% under rounding-level perturbations, so without the
re-sync the second step would compare two different states.

Readings (port vs JAX; the floor run's in brackets): the forward's recon
≤ 2.5e-5 abs, commit 1.1e-6 relative, ids all equal; step 1: losses
≤ 1.1e-6 (0), gradients encoder 4.9e-2 (1.1e-1), decoder 9.0e-6
(1.6e-6), updates off by more than 1e-3·lr encoder 2.0% (4.2%), decoder
0.35% (0.35%), codebook ≤ 2.4e-7 (9.8e-8); step 2: losses ≤ 1.1e-6
(≤ 1.4e-7), gradients encoder 8.1e-2 (8.6e-2), decoder 1.7e-6 (9.0e-7),
updates encoder 91% (92%; not held: Adam's second step no longer saturates),
decoder 0.35% (0.34%), codebook ≤ 4.0e-7 (2.0e-7); updates (relative
norm) step 1 encoder 0.24 (0.38), decoder 1.3e-2 (1.4e-2), step 2
encoder 0.16 (0.15), decoder 1.4e-2 (9.9e-3); bf16 at 32³: losses
≤ 2.6e-3, codebook ≤ 2.4e-3 of its largest value, the last up blocks'
weight gradients 0.11-0.14 from JAX's bf16 ones, the head's weight
4.9e-3 and bias 4.5e-4, the modules' weights 0.34 and 0.25 from JAX's
f32 gradient (JAX's bf16 0.33 and 0.25).
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.cli import edit_volume as jedit
from medical_image_editing_tpu.cli import train_volumetric as jtrain
from medical_image_editing_tpu.models import volumetric as jvol
from medical_image_editing_tpu.ops.vq import vq_init
from medical_image_editing_tpu.train.state import make_optimizer as jmake_optimizer
from medical_image_editing_tpu.train.volumetric import make_volumetric_train_step as jmake_step
from medical_image_editing_tpu_torch.cli import edit_volume as tedit
from medical_image_editing_tpu_torch.cli import train_volumetric as ttrain
from medical_image_editing_tpu_torch.models import volumetric as tvol
from medical_image_editing_tpu_torch.ops.vq import VQState, vq_scores
from medical_image_editing_tpu_torch.train import volumetric as tvt
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.checkpoint import save_state_dir

FILTERS = (4, 8, 16)
K = 5
LR = 1e-4
CUBE = (2, 16, 16, 16, 1)
ODD = (2, 8, 16, 24, 1)
BASE_RTOL = 1e-4
MAX_MISMATCH = 1e-3
RATIO_CAP = 0.5
BF16_LOSS_RTOL = 2.0**-7
BF16_CODEBOOK_RTOL = 2.0**-6
BF16_HEAD_GRAD_REL = 2.0**-5
BF16_NEAR_GRAD_REL = 0.3
BF16_GRAD_NOISE = 1.5
BF16_GRAD_CAP = 0.9
# the weights nearest the loss: each module's last up block and the head
BF16_NEAR = ("UpBlock3D_1.DoubleConv3D_0.Conv_0.weight",
             "UpBlock3D_1.DoubleConv3D_0.Conv_1.weight")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vol(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _jax_init(shape, dtype=None, use_remat=False):
    """`init_volumetric`'s modules and variables, its inits jitted (flax's
    un-jitted 3-D init takes ~25 s here)."""
    enc = jvol.VolumetricUNetEncoder(filters=FILTERS, dtype=dtype, use_remat=use_remat)
    dec = jvol.VolumetricUNetDecoder(out_channels=shape[-1], filters=FILTERS, dtype=dtype,
                                     use_remat=use_remat)

    @jax.jit
    def init(key):
        k0, k1, k2 = jax.random.split(key, 3)
        x0 = jnp.zeros(shape, jnp.float32)
        ev = enc.init(k0, x0, train=False)
        dv = dec.init(k1, enc.apply(ev, x0, train=False), train=False)
        return ev, dv, vq_init(k2, K, FILTERS[0])

    ev, dv, vq = init(jax.random.key(0))
    return SimpleNamespace(enc=enc, dec=dec, ev=ev, dv=dv, vq=vq)


def _port(ji, dtype=None, use_remat=False, shape=CUBE):
    """The port's models, codebook and Adams from the JAX variables."""
    enc, dec, _, eo, do = tvt.init_volumetric(
        torch.Generator().manual_seed(0), filters=FILTERS, dict_size=K, volume_shape=shape,
        lr=LR, dtype=dtype, use_remat=use_remat, device="cpu")
    sd = bridge.from_jax_volumetric(ji.ev, ji.dv, ji.vq)
    enc.load_state_dict(sd["enc"], strict=True)
    dec.load_state_dict(sd["dec"], strict=True)
    vq = VQState(*(torch.tensor(np.asarray(a)) for a in ji.vq))
    return SimpleNamespace(enc=enc, dec=dec, vq=vq, eo=eo, do=do)


@pytest.fixture(scope="module")
def ji_cube():
    return _jax_init(CUBE)


@pytest.fixture(scope="module")
def ji_odd():
    return _jax_init(ODD)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


# -- modules ------------------------------------------------------------------


def test_instance_norm_3d_matches_jax():
    x = _vol(1, (2, 6, 8, 10, 3)) * 3.0 + 0.5
    want = np.asarray(jvol.instance_norm_3d(jnp.asarray(x)))
    got = tvol.instance_norm_3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    _close(got.permute(0, 2, 3, 4, 1).numpy(), want)
    xb = jnp.asarray(x, jnp.bfloat16)
    assert jvol.instance_norm_3d(xb).dtype == jnp.bfloat16
    assert tvol.instance_norm_3d(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("block", ["DoubleConv3D", "ResBlock3D", "UpBlock3D"])
def test_blocks_match_jax(block):
    cin, f = 3, 5
    x = _vol(2, (2, 4, 6, 8, cin))
    if block == "UpBlock3D":
        skip = _vol(3, (2, 8, 12, 16, 4))
        jm = jvol.UpBlock3D(f)
        args = (jnp.asarray(x), jnp.asarray(skip))
        tm = tvol.UpBlock3D(cin + 4, f)
        targs = (torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                 torch.from_numpy(skip).permute(0, 4, 1, 2, 3))
    else:
        jm = getattr(jvol, block)(f)
        args = (jnp.asarray(x),)
        tm = getattr(tvol, block)(cin, f)
        targs = (torch.from_numpy(x).permute(0, 4, 1, 2, 3),)
    variables = jax.jit(jm.init)(jax.random.key(1), *args)
    want = jm.apply(variables, *args)
    tm.load_state_dict(bridge.from_jax_volumetric_params(variables["params"]), strict=True)
    with torch.no_grad():
        got = tm(*targs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 4, 1).numpy(), np.asarray(w))


def test_state_dict_keys_are_the_flax_paths(ji_cube):
    """The carried keys are exactly the port modules' keys, under the
    remat-stable flax names (no `Checkpoint*`), and remat changes none."""
    sd = bridge.from_jax_volumetric(ji_cube.ev, ji_cube.dv, ji_cube.vq)
    for remat in (False, True):
        p = tvt.init_volumetric(torch.Generator().manual_seed(0), filters=FILTERS,
                                dict_size=K, volume_shape=CUBE, use_remat=remat, device="cpu")
        assert set(p[0].state_dict()) == set(sd["enc"])
        assert set(p[1].state_dict()) == set(sd["dec"])
    assert "ResBlock3D_1.Conv_0.weight" in sd["enc"] and "ResBlock3D_1.Conv_0.bias" not in sd["enc"]
    assert sd["dec"]["Conv_0.weight"].shape == (1, FILTERS[0], 1, 1, 1)
    assert sd["enc"]["UpBlock3D_1.DoubleConv3D_0.Conv_0.weight"].shape == (4, 12, 3, 3, 3)
    assert set(sd["vq"]) == {"embed", "cluster_size", "embed_avg"}
    assert sd["vq"]["embed_avg"].shape == (FILTERS[0], K)  # the port's (C, K)


# -- the forward --------------------------------------------------------------


@pytest.mark.parametrize("shape", [CUBE, ODD], ids=["16cube", "8x16x24"])
def test_forward_matches_jax(shape, ji_cube, ji_odd):
    ji = ji_cube if shape == CUBE else ji_odd
    p = _port(ji, shape=shape)
    vol = _vol(4, shape)
    recon, commit, ids, new_vq = jvol.volumetric_forward(ji.enc, ji.dec, ji.ev, ji.dv, ji.vq,
                                                          jnp.asarray(vol))
    with torch.no_grad():
        feats = p.enc(torch.from_numpy(vol).permute(0, 4, 1, 2, 3))
        r2, c2, ids2, vq2 = tvol.volumetric_forward(p.enc, p.dec, p.vq, torch.from_numpy(vol))
    assert r2.shape == shape and ids2.shape == shape[:4] and r2.dtype == torch.float32
    top2 = vq_scores(p.vq.embed, feats.permute(0, 2, 3, 4, 1).reshape(-1, FILTERS[0]))
    top2 = top2.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-5 * top2.abs().max()).reshape(shape[:4]).numpy()
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(ids2.numpy()[clear], np.asarray(ids)[clear])
    assert len(np.unique(np.asarray(ids))) > 2  # more than one code: the order matters
    np.testing.assert_allclose(float(c2), float(commit), rtol=1e-5)
    np.testing.assert_allclose(r2.numpy(), np.asarray(recon), atol=1e-4, rtol=0)
    for a, b in zip(vq2, new_vq):
        _close(a.numpy(), np.asarray(b))


def test_size_not_divisible_is_refused():
    enc = tvol.VolumetricUNetEncoder(filters=(8, 16, 32, 64))
    with pytest.raises(ValueError, match="12x16x16 is not divisible by 2\\^3 = 8"):
        enc(torch.zeros(1, 1, 12, 16, 16))


# -- the training step --------------------------------------------------------


@contextlib.contextmanager
def rounding_floor(seed=0):
    """Inside the block the port runs perturbed at the rounding level:
    PyTorch's native CPU convolutions instead of oneDNN's, and the
    quantized features moved by one ulp up or down at random."""
    gen = torch.Generator().manual_seed(seed)
    real = tvol.vq_apply

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        up = torch.randint(0, 2, q.shape, generator=gen).bool()
        moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
        return (q + (moved - q).detach(), *rest)

    tvol.vq_apply = nudged
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        tvol.vq_apply = real


def _snapshot(p, vq):
    out = {}
    for part, module, opt in (("enc", p.enc, p.eo), ("dec", p.dec, p.do)):
        out[part] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        out[part + "_mu"] = {k: opt.state[q]["exp_avg"].clone() if q in opt.state
                             else torch.zeros_like(q) for k, q in module.named_parameters()}
    out["vq"] = [t.clone() for t in vq]
    return out


def _adam(opt_state):
    return next(x for x in opt_state if hasattr(x, "mu"))


def _jax_snapshot(ev, dv, vq, eo, do):
    sd = bridge.from_jax_volumetric(ev, dv, vq)
    return {"enc": sd["enc"], "dec": sd["dec"],
            "enc_mu": bridge.from_jax_volumetric_params(_adam(eo).mu),
            "dec_mu": bridge.from_jax_volumetric_params(_adam(do).mu),
            "vq": [torch.tensor(np.asarray(a)) for a in vq]}


def _load_jax_state(p, state):
    """Load a JAX step's state (variables, Adam's moments and count, the
    codebook) into the port's modules and Adams; returns the codebook."""
    ev, dv, vq, eo, do = state
    sd = bridge.from_jax_volumetric(ev, dv, vq)
    for part, module, opt, o in (("enc", p.enc, p.eo, eo), ("dec", p.dec, p.do, do)):
        module.load_state_dict(sd[part], strict=True)
        adam = _adam(o)
        mu = bridge.from_jax_volumetric_params(adam.mu)
        nu = bridge.from_jax_volumetric_params(adam.nu)
        for k, q in module.named_parameters():
            opt.state[q] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[k],
                            "exp_avg_sq": nu[k]}
    return VQState(*(torch.tensor(np.asarray(a)) for a in vq))


def _run_jax(ji, vols, dtype=None, use_remat=False):
    """JAX steps on `vols`: per step its state after, the snapshot of that
    state and its metrics."""
    enc = jvol.VolumetricUNetEncoder(filters=FILTERS, dtype=dtype, use_remat=use_remat)
    dec = jvol.VolumetricUNetDecoder(out_channels=1, filters=FILTERS, dtype=dtype,
                                     use_remat=use_remat)
    etx, dtx = jmake_optimizer(LR), jmake_optimizer(LR)
    step = jmake_step(enc, dec, etx, dtx)
    s = (ji.ev, ji.dv, ji.vq, etx.init(ji.ev["params"]), dtx.init(ji.dv["params"]))
    out = []
    for v in vols:
        *s, m = step(*s, jnp.asarray(v))
        out.append(SimpleNamespace(state=tuple(s), after=_jax_snapshot(*s),
                                   m={k: float(x) for k, x in m.items()}))
    return out


def _run_port(ji, vols, dtype=None, use_remat=False, floor=False, resync=()):
    """Port steps on `vols` from the JAX variables; with `resync` (JAX's
    steps) each step n ≥ 2 starts from JAX's state after step n − 1, so
    every step is held from the same state. Per step the snapshots before
    and after it and its metrics."""
    p = _port(ji, dtype=dtype, use_remat=use_remat)
    step = tvt.make_volumetric_train_step(p.enc, p.dec, p.eo, p.do)
    vq, out = p.vq, []
    with rounding_floor() if floor else contextlib.nullcontext():
        for n, v in enumerate(vols):
            if n and resync:
                vq = _load_jax_state(p, resync[n - 1].state)
            before = _snapshot(p, vq)
            vq, m = step(vq, v)
            out.append(SimpleNamespace(before=before, after=_snapshot(p, vq),
                                       m={k: float(x) for k, x in m.items()}))
    return out


@pytest.fixture(scope="module")
def steps(ji_cube):
    vols = [_vol(21, CUBE), _vol(22, CUBE)]
    jax_steps = _run_jax(ji_cube, vols)
    return SimpleNamespace(
        want=jax_steps,
        port=_run_port(ji_cube, vols, resync=jax_steps),
        floor=_run_port(ji_cube, vols, floor=True, resync=jax_steps))


def limit(floor):
    """5× the floor, at least BASE_RTOL, at most RATIO_CAP: below the 1.0
    that a zero gradient or update reads."""
    return min(max(5 * floor, BASE_RTOL), RATIO_CAP)


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _cat(sd, names):
    return torch.cat([sd[k].flatten() for k in names])


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", ["total", "recon", "commit"])
def test_step_losses_match_jax(steps, n, name):
    got, want = steps.port[n - 1].m[name], steps.want[n - 1].m[name]
    floor = steps.floor[n - 1].m[name]
    tol = limit(abs(floor - got) / max(abs(got), 1e-12))
    assert abs(got - want) <= tol * abs(want), (name, got, want, floor)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("part", ["enc", "dec"])
def test_step_gradients_match_jax(steps, n, part):
    """Adam's first moment after step n ((1 − β1)·g after the first)."""
    got = steps.port[n - 1].after[part + "_mu"]
    names = sorted(got)
    got = _cat(got, names)
    want = _cat(steps.want[n - 1].after[part + "_mu"], names)
    floor = _rel(_cat(steps.floor[n - 1].after[part + "_mu"], names), got)
    assert _rel(got, want) <= limit(floor), (part, _rel(got, want), floor)


def _mismatch(d, ref, lr):
    return float(((d - ref).abs() > 1e-3 * lr).float().mean())


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("part", ["enc", "dec"])
def test_step_parameter_updates_match_jax(steps, n, part):
    """The update (relative Frobenius norm) within `limit` of the floor's;
    after the first step, which is ±lr wherever |g| ≫ 1e-8, also the
    fraction of elements off by more than 1e-3·lr, within 5× the floor's,
    at least MAX_MISMATCH, at most RATIO_CAP (Adam's later steps no longer
    saturate, so the fraction reads ~0.9 on both sides there and says
    nothing)."""
    port, names = steps.port[n - 1], sorted(steps.port[n - 1].before[part + "_mu"])
    start = _cat(port.before[part], names)
    got = _cat(port.after[part], names) - start
    want = _cat(steps.want[n - 1].after[part], names) - start
    floor = _cat(steps.floor[n - 1].after[part], names) - start
    err, ref = _rel(got, want), _rel(floor, got)
    assert err <= limit(ref), (part, err, ref)
    if n == 1:
        err, ref = _mismatch(got, want, LR), _mismatch(floor, got, LR)
        assert err <= min(max(5 * ref, MAX_MISMATCH), RATIO_CAP), (part, err, ref)
    assert float(got.abs().max()) > 0.5 * LR


@pytest.mark.parametrize("n", [1, 2])
def test_step_codebook_matches_jax(steps, n):
    """The EMA-updated codebook state, which moved."""
    port = steps.port[n - 1]
    for i, name in enumerate(("embed", "cluster_size", "embed_avg")):
        got, want = port.after["vq"][i], steps.want[n - 1].after["vq"][i]
        floor = float((steps.floor[n - 1].after["vq"][i] - got).abs().max()) / max(
            float(got.abs().max()), 1e-12)
        tol = limit(floor)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=1e-6 + tol,
                                   err_msg=name)
    assert not torch.equal(port.after["vq"][1], port.before["vq"][1])


def test_remat_matches_plain_bit_for_bit(ji_cube):
    """`use_remat` changes memory only: two steps with it give the plain
    steps' losses, parameters, moments and codebook bit for bit."""
    vols = [_vol(21, CUBE), _vol(22, CUBE)]
    plain = _run_port(ji_cube, vols)
    remat = _run_port(ji_cube, vols, use_remat=True)
    for a, b in zip(plain, remat):
        assert a.m == b.m
        for part in ("enc", "dec", "enc_mu", "dec_mu"):
            for k in a.after[part]:
                assert torch.equal(a.after[part][k], b.after[part][k]), (part, k)
        for x, y in zip(a.after["vq"], b.after["vq"]):
            assert torch.equal(x, y)


def test_bf16_remat_step_matches_jax(ji_cube):
    """The JAX package's memory plan (bf16 compute, per-block remat): one
    step against JAX's bf16 step from the same f32 variables, on two
    structured 32³ volumes (`_synthetic_volumes`). Parameters, moments and
    the codebook stay f32 on both sides. Held: the losses to two bf16 ulps,
    the codebook to 2⁻⁶; the weight gradients nearest the loss (each
    module's last up block, behind one instance norm, and the head),
    where bf16 rounding does not dominate, directly against JAX's bf16
    ones; the head's bias against JAX's f32 gradient (XLA's bf16 reduction
    of it reads 98% from f32, the port's 0.04%). Deeper, both sides'
    gradients are bf16 rounding divided by the instance norms' channel
    spreads (JAX's own bf16 weight gradients up to 93% from its f32 ones),
    so there each tensor is not held alone: each module's weights together
    (their norm is mostly the layers nearest the loss) are held to 1.5×
    JAX's own distance from its f32 gradient, at most BF16_GRAD_CAP (a zero
    gradient reads 1.0). The biases of convolutions followed by an instance
    norm have an exact gradient of 0 and are not compared."""
    vols = [ttrain._synthetic_volumes(2, 32, 3)]
    (want,) = _run_jax(ji_cube, vols, dtype=jnp.bfloat16, use_remat=True)
    (want_f32,) = _run_jax(ji_cube, vols)
    (port,) = _run_port(ji_cube, vols, dtype=torch.bfloat16, use_remat=True)
    for name in ("total", "recon", "commit"):
        assert abs(port.m[name] - want.m[name]) <= BF16_LOSS_RTOL * abs(want.m[name]), (
            name, port.m[name], want.m[name])
    assert port.m["commit"] != want_f32.m["commit"]  # the step did run in bf16
    for part in ("enc", "dec"):
        mu, jmu, fmu = (r.after[part + "_mu"] for r in (port, want, want_f32))
        for k in BF16_NEAR:
            assert _rel(mu[k], jmu[k]) <= BF16_NEAR_GRAD_REL, (part, k, _rel(mu[k], jmu[k]))
        names = sorted(k for k in mu if k.endswith("weight"))
        got = _cat(mu, names)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        own = _rel(got, _cat(fmu, names))
        jax_own = _rel(_cat(jmu, names), _cat(fmu, names))
        assert own <= min(BF16_GRAD_NOISE * jax_own, BF16_GRAD_CAP), (part, own, jax_own)
    mu, jmu, fmu = (r.after["dec_mu"] for r in (port, want, want_f32))
    assert _rel(mu["Conv_0.weight"], jmu["Conv_0.weight"]) <= BF16_HEAD_GRAD_REL
    assert _rel(mu["Conv_0.bias"], fmu["Conv_0.bias"]) <= BF16_HEAD_GRAD_REL
    for got, w in zip(port.after["vq"], want.after["vq"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=BF16_CODEBOOK_RTOL,
                                   atol=BF16_CODEBOOK_RTOL * float(w.abs().max()))


# -- editing ------------------------------------------------------------------


class _IdentityDecoder(torch.nn.Module):
    """Returns its input (NCDHW): isolates the edit fn's mask, lookup and
    rescale for the numpy golden of `tests/test_volumetric.py`."""

    def forward(self, x):
        return x


class _JaxIdentityDecoder:
    def apply(self, variables, embed, train):
        return embed


def test_edit_math_golden():
    rng = np.random.default_rng(0)
    vq = vq_init(jax.random.key(0), 5, 3)
    tvq = VQState(*(torch.tensor(np.asarray(a)) for a in vq))
    ids = rng.integers(0, 6, (2, 4, 4, 4)).astype(np.int32)
    out = tedit.make_volumetric_edit_fn(_IdentityDecoder(), device="cpu")(tvq, ids).numpy()

    codebook = np.asarray(vq.embed)
    bg = ids == 0
    embed = codebook[np.where(bg, 1, ids) - 1]
    mask = (~bg).astype(np.float32)
    embed *= mask[..., None]
    embed *= (4 * 4 * 4 / np.maximum(mask.sum(axis=(1, 2, 3)), 1.0))[:, None, None, None, None]
    np.testing.assert_allclose(out, embed[..., 0], rtol=1e-6, atol=1e-6)
    want = np.asarray(jedit.make_volumetric_edit_fn(_JaxIdentityDecoder())(
        {}, vq, jnp.asarray(ids)))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("shape", [CUBE, ODD], ids=["16cube", "8x16x24"])
def test_edit_fn_matches_jax(shape, uint8, ji_cube, ji_odd):
    ji = ji_cube if shape == CUBE else ji_odd
    p = _port(ji, shape=shape)
    ids = np.random.default_rng(5).integers(0, K + 1, shape[:4]).astype(np.int32)
    ids[1] = 0  # an all-background volume: the rescale's max(Σmask, 1)
    out = "uint8" if uint8 else None
    want = np.asarray(jedit.make_volumetric_edit_fn(ji.dec, output_dtype=out)(
        ji.dv, ji.vq, jnp.asarray(ids)))
    got = tedit.make_volumetric_edit_fn(p.dec, output_dtype=out, device="cpu")(p.vq, ids).numpy()
    assert got.shape == want.shape == shape[:4] and got.dtype == want.dtype
    if uint8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_edit_labels_checked_and_negative_wrap(ji_cube):
    p = _port(ji_cube)
    edit = tedit.make_volumetric_edit_fn(p.dec, device="cpu")
    ids = np.ones(CUBE[:4], np.int32)
    ids[0, 2:5, 3:9, 1:4] = K + 1
    with pytest.raises(ValueError, match=r"painted labels \[6\] outside \[-4, 5\]"):
        edit(p.vq, ids)
    ids[0, 2:5, 3:9, 1:4] = 1 - K - 1
    with pytest.raises(ValueError, match="outside"):
        edit(p.vq, ids)
    # labels 1 − K .. −1 wrap to rows from the end, as in JAX: the same
    # decode as their positive twins (label l < 0 is row K + l − 1, label
    # K + l), and JAX's decode of them
    ids = np.random.default_rng(7).integers(1 - K, K + 1, CUBE[:4]).astype(np.int32)
    twins = np.where(ids < 0, ids + K, ids)
    got = edit(p.vq, ids).numpy()
    np.testing.assert_array_equal(got, edit(p.vq, twins).numpy())
    want = np.asarray(jedit.make_volumetric_edit_fn(ji_cube.dec)(ji_cube.dv, ji_cube.vq,
                                                                 jnp.asarray(ids)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# -- the CLIs -----------------------------------------------------------------


@pytest.mark.parametrize("n,size,seed", [(3, 16, 0), (2, 10, 7)])
def test_synthetic_volumes_bit_identical(n, size, seed):
    got = ttrain._synthetic_volumes(n, size, seed)
    want = jtrain._synthetic_volumes(n, size, seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, size, size, size, 1)
    assert got.tobytes() == want.tobytes()


def test_load_volumes_bit_identical(tmp_path):
    rng = np.random.default_rng(3)
    for i, dtype in enumerate((np.int16, np.float64, np.float32)):
        np.save(tmp_path / f"v{i}.npy", (rng.normal(0, 800, (6, 8, 10))).astype(dtype))
    got = ttrain._load_volumes(str(tmp_path), -1000.0, 1000.0)
    want = jtrain._load_volumes(str(tmp_path), -1000.0, 1000.0)
    assert got.shape == (3, 6, 8, 10, 1) and got.tobytes() == want.tobytes()
    np.save(tmp_path / "v9.npy", np.zeros((6, 8, 9)))
    with pytest.raises(SystemExit, match="!= first volume"):
        ttrain._load_volumes(str(tmp_path), -1000.0, 1000.0)


def test_train_cli_batches_follow_jax_order():
    """The port draws batches as the JAX CLI does
    (`default_rng(seed).choice(n, batch, replace=n < batch)`), so both
    train on the same volumes in the same order."""
    import inspect

    for mod in (jtrain, ttrain):
        assert "rng.choice(n, args.batch, replace=n < args.batch)" in inspect.getsource(mod.main)


def test_cli_train_then_edit(tmp_path, capsys):
    """`train_volumetric` then `edit_volume` with `--device cpu`: the step
    lines, the checkpoint (`state.pt` with the JAX layout's three parts),
    the PNG; then the trained encoder's ids, painted, decoded as `.npy`, as
    `.nii.gz` (the same decode) and as uint8."""
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    out = tmp_path / "vol_out"
    rc = ttrain.main(["--steps", "3", "--batch", "2", "--size", "16", "--n-synthetic", "4",
                      "--filters", "4,8,16", "--dict-size", str(K), "--log-every", "1",
                      "--out", str(out), "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == ["step 1", "step 2", "step 3"]
    assert all("total=" in ln and "recon=" in ln and "commit=" in ln for ln in steps)
    ckpt = out / "volumetric_ckpt"
    sd = load_state_file(str(ckpt))
    assert set(sd) == {"enc", "dec", "vq"} and sd["vq"]["embed"].shape == (K, 4)
    assert float(sd["vq"]["cluster_size"].sum()) > 0  # the EMA ran
    assert (out / "recon_mid.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"

    # encode a volume with the trained weights, paint a box, decode
    enc = tvol.VolumetricUNetEncoder(filters=FILTERS)
    enc.load_state_dict(sd["enc"])
    decoder, vq = tedit.load_volumetric_checkpoint(str(ckpt), filters=FILTERS, dict_size=K,
                                                   device="cpu")
    vol = ttrain._synthetic_volumes(1, 16, 0)
    with torch.no_grad():
        _, _, ids, _ = tvol.volumetric_forward(enc, decoder, vq, torch.from_numpy(vol),
                                               train=False)
    ids = ids[0].numpy().astype(np.int32)
    ids[4:9, 2:7, 5:12] = 3
    labels = tmp_path / "labels"
    labels.mkdir()
    np.save(labels / "a.npy", ids)
    nifti.save(np.transpose(ids, (2, 1, 0)).astype(np.float64), str(labels / "b.nii.gz"))
    np.save(labels / "c.npy", np.where(ids == 3, 0, ids))
    edited = tmp_path / "edited"
    args = ["--ckpt", str(ckpt), "--labels", str(labels), "--filters", "4,8,16",
            "--dict-size", str(K), "--batch", "2", "--device", "cpu"]
    assert tedit.main([*args, "--out", str(edited)]) == 0
    rec_npy = np.load(edited / "edited_a.npy")
    rec_nii = np.transpose(nifti.load(str(edited / "edited_b.nii.gz")), (2, 1, 0))
    assert rec_npy.shape == (16, 16, 16) and np.isfinite(rec_npy).all()
    np.testing.assert_allclose(rec_nii, rec_npy, atol=1e-6)
    want = tedit.make_volumetric_edit_fn(decoder, device="cpu")(vq, ids[None])[0].numpy()
    np.testing.assert_allclose(rec_npy, want, atol=1e-5, rtol=0)  # batch 2 against 1
    assert np.load(edited / "edited_c.npy").shape == (16, 16, 16)  # the padded tail batch
    assert tedit.main([*args, "--out", str(tmp_path / "u8"), "--uint8"]) == 0
    u8 = np.load(tmp_path / "u8" / "edited_a.npy")
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, ((np.clip(rec_npy, -1, 1) + 1) * 127.5).astype(np.uint8))

    with pytest.raises(ValueError, match="codebook has 5 entries, --dict-size says 7"):
        tedit.load_volumetric_checkpoint(str(ckpt), filters=FILTERS, dict_size=7, device="cpu")
    np.save(labels / "a.npy", np.full((16, 16, 16), K + 1, np.int32))
    with pytest.raises(ValueError, match="painted labels"):
        tedit.main([*args, "--out", str(edited)])


def test_cli_refusals(tmp_path):
    # an Orbax directory (no state.pt) of the JAX package
    orbax = tmp_path / "volumetric_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="ROADMAP item 22a"):
        tedit.load_volumetric_checkpoint(str(orbax), filters=FILTERS, dict_size=K,
                                         device="cpu")
    with pytest.raises(ValueError, match="ROADMAP item 22a"):
        tedit.main(["--ckpt", str(orbax), "--labels", str(tmp_path), "--out", str(tmp_path),
                    "--device", "cpu"])


def test_checkpoint_carried_from_jax_decodes_as_jax(tmp_path, ji_cube):
    """A `state.pt` written from JAX variables (`from_jax_volumetric`)
    loads through `load_volumetric_checkpoint` and decodes as the JAX edit
    function does."""
    save_state_dir(str(tmp_path / "ckpt"),
                   bridge.from_jax_volumetric(ji_cube.ev, ji_cube.dv, ji_cube.vq))
    decoder, vq = tedit.load_volumetric_checkpoint(str(tmp_path / "ckpt"), filters=FILTERS,
                                                   dict_size=K, device="cpu")
    for a, b in zip(vq, ji_cube.vq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = np.random.default_rng(6).integers(0, K + 1, CUBE[:4]).astype(np.int32)
    want = np.asarray(jedit.make_volumetric_edit_fn(ji_cube.dec)(ji_cube.dv, ji_cube.vq,
                                                                 jnp.asarray(ids)))
    got = tedit.make_volumetric_edit_fn(decoder, device="cpu")(vq, ids).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
