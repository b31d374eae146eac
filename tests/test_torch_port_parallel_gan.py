"""Data-parallel GAN training (ROADMAP 15(ii)): two ranks of the port
against the JAX package's `parallel.data_parallel` over two CPU devices on
the concatenated batch, each collective on its own, then the second-stage
step and the VQGAN step whole. The multi-window steps are in
`tests/test_torch_port_parallel_gan_mw.py` (first and second step) and
`tests/test_torch_port_parallel_gan_joint.py` (the joint step), which share
this module's helpers; the CLI runs on two ranks in
`tests/test_torch_port_parallel.py`.

The ranks are two gloo processes (`tests/torch_parallel_worker.py`, torch
and the port only) started as `tests/test_torch_port_parallel.py` starts
them (spawn, a `file://` rendezvous in a tmp dir, a timeout a spawn); JAX
runs here, on `jax.devices()[:2]`, while the ranks run, each JAX function
compiled once in its module fixture. Rank r holds rows [r·B, (r+1)·B) of
each input, JAX's `P('data')` layout, and draws from JAX's per-device keys
(`fold_in(k, r)`, `train/state.py::per_device_keys`), replayed into the
port's draws: each rank its own CutMix boxes and views. Widths: encoder
(4, 4, 8, 8, 8), decoder (4, 8, 8) (no level at 32 channels, so no
convolution routes to the packed kernel), `dict_size` 5, the U-Net
discriminator at `D_ch` 2 and resolution 128, 32² images, 2 rows a rank;
the VQGAN as `tests/test_torch_port_vqgan.py` builds it. The JAX side
assigns codes with its plain reference (`knn_backend: "xla"`), the port
with `"pallas"` (on the CPU the kernel's plain version): the same function.

Tolerances, float32 (those of `tests/test_torch_port_second_stage.py`,
`test_torch_port_multi_window*.py` and `test_torch_port_vqgan.py`):
* ActNorm's data init (each rank's mean and std averaged): the output and
  the captured statistics rtol 1e-5, atol 1e-6.
* the PatchGAN's synced BatchNorm (with spectral norm): logits, input
  gradients, the averaged parameter gradients rtol 1e-4, atol 1e-6 (sums
  of a few hundred terms in other orders through three convolutions); the
  running statistics and spectral-norm vectors rtol 1e-5, atol 1e-6.
* the VQGAN's codebook statistics averaged before the EMA: the EMA state
  rtol 1e-5, atol 1e-6; the reconstruction rtol 1e-5 (atol 1e-5 × its
  largest magnitude), as the VQGAN forward test.
* the inner loop (the PatchGAN, two iterations): the losses rtol 1e-4,
  Adam's first moments (relative Frobenius norm) 1e-4, the updates: at
  most 0.1% of the elements more than 1e-3·lr apart, the buffers rtol
  1e-4, atol 1e-6.
* the whole steps: losses rtol 1e-4 (atol 1e-6 for the consistency term,
  1e-3 for the distance loss); gradients (Adam's first moment, relative
  Frobenius norm per module) within 5× the port's own rounding floor or
  1e-4, whichever is wider; the one-step updates: the fraction of
  elements more than 1e-3·lr apart within 5× the floor's or 0.1%; the
  spectral-norm vectors elementwise within the same limit of the floor's
  largest relative difference (atol 1e-6 + that limit); the decoder's
  BatchNorm running stats and the codebook rtol 1e-4, atol 1e-6. The floor
  is the same two-rank step perturbed at the rounding level (PyTorch's
  native convolutions in place of oneDNN's, the quantized features one
  ulp up or down at random), as the single-process tests take it.
* the two ranks' states (modules, Adam states, generator) and metrics are
  bit for bit equal, the average of the discriminator's buffers changed
  no element on either rank (the weights are replicated), and each step
  issues exactly the all-reduces it should, with the bytes they carry.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models import vqgan as jvqgan
from medical_image_editing_tpu.models.actnorm import ActNorm as JActNorm
from medical_image_editing_tpu.models.discriminator import NLayerDiscriminator as JNLayer
from medical_image_editing_tpu.models.unet_discriminator import UNetDiscriminator as JUNetD
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.models.unet_encoder import init_codebook_from_batch
from medical_image_editing_tpu.ops.losses import hinge_d_loss
from medical_image_editing_tpu.ops.vq import vq_init
from medical_image_editing_tpu.parallel import (
    DATA_AXIS,
    create_mesh,
    data_parallel,
    replicate,
    shard_batch,
)
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import multi_window as jmw
from medical_image_editing_tpu.train import second_stage as jss
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.train.vqgan_stage import make_vqgan_step as j_make_vqgan_step
from medical_image_editing_tpu.utils.config import load_json as jload_json
from medical_image_editing_tpu_torch.models import VQGAN
from medical_image_editing_tpu_torch.utils import weights as bridge
from test_torch_port_augment import jax_view_draws, to_torch_draws
from test_torch_port_multi_window import cutmix_draws
from test_torch_port_parallel import Ranks

WORLD = 2
B, SIZE = 2, 32  # rows a rank, side
BASE_RTOL = 1e-4
MAX_MISMATCH = 1e-3
RANKS_TIMEOUT = 300  # seconds from a spawn's start: the ranks run while JAX compiles
KINDS = ("second", "vqgan")
METRICS = {
    "second": ["gen_total", "recon", "freq", "perceptual", "gen", "unet_perceptual",
               "dis_total", "dis", "cutmix", "consistency", "total"],
    "mw_first": ["total", "commit", "cross", "dist", "reg", "recon", "freq", "perceptual"],
    "mw_second": ["gen_total", "recon", "freq", "perceptual", "gen", "unet_perceptual",
                  "dis_total", "dis", "cutmix", "consistency", "total"],
    "joint": ["gen_total", "commit", "cross", "dist", "reg", "recon", "freq", "perceptual",
              "gen", "unet_perceptual", "dis_total", "dis", "cutmix", "consistency", "total"],
    "vqgan": ["gen_total", "recon", "freq", "perceptual", "commit", "gen", "unet_perceptual",
              "dis_total", "dis", "cutmix", "consistency", "total"],
}


def images(seed=21, n=WORLD * B):
    """Smooth slices with blobs and noise in [-1, 1], (n,H,W,1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    imgs = []
    for _ in range(n):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.05, 0.1), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img + 0.3 * rng.normal(size=img.shape), -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state_np(s):
    return SimpleNamespace(**{f: _np(getattr(s, f)) for f in (
        "enc_vars", "dec_vars", "vq", "dis_vars", "enc_opt", "dec_opt", "dis_opt")})


def vqgan_shape():
    """The port's VQGAN of the test's configuration (the bridge's layout)."""
    return VQGAN(**worker.VQGAN_KW)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def jax_setup(kind, image):
    """The JAX models of `kind` built with `DATA_AXIS` (jitted inits), the
    initial state (the U-Net codebook k-means on the batch, so that no id
    sits at a near tie) and its step."""
    jcfg = jload_json(worker.CONFIGS[kind])
    x0 = jnp.zeros((1, SIZE, SIZE, 1))
    txs = [jstate.make_optimizer_from_config(c)
           for c in (jcfg.enc_optim, jcfg.dec_optim, jcfg.dis_optim)]
    fc = jfs.loss_config_from_json(jcfg.loss)
    sc = jss.second_stage_config_from_json(jcfg.loss)
    jdis = dis_vars = None
    if kind != "mw_first":
        jdis = JUNetD(D_ch=worker.GAN_DCH, D_attn="0", resolution=128)
        dis_vars = jax.jit(lambda k: jdis.init(k, x0, train=False))(jax.random.key(5))
    if kind == "vqgan":
        m = jvqgan.VQGAN(**{**worker.VQGAN_KW, "knn_backend": "xla"}, axis_name=DATA_AXIS)
        vq = vq_init(jax.random.key(41), worker.VQGAN_KW["dict_size"],
                     worker.VQGAN_KW["emb_dim"])
        variables = jax.jit(lambda k: m.init(k, x0, vq, train=False))(jax.random.key(0))
        s0 = jstate.create_train_state(jax.random.key(4), {"params": {}}, variables, vq,
                                       txs[0], txs[1], dis_vars=dis_vars, dis_tx=txs[2])
        step = j_make_vqgan_step(m, jdis, txs[1], txs[2], loss_cfg=sc, w_commit=fc.w_commit,
                                 axis_name=DATA_AXIS)
        return SimpleNamespace(jcfg=jcfg, s0=s0, step=step, m=m)
    jenc = JEncoder(filters=worker.GAN_ENC, dict_size=worker.GAN_DICT,
                    momentum=float(jcfg.model.vqmodel.momentum), knn_backend="xla",
                    axis_name=DATA_AXIS)
    jdec = JDecoder(out_channels=1, filters=worker.GAN_DEC, dropped_skip_layers=(),
                    use_pixel_shuffle=False, axis_name=DATA_AXIS)
    enc_vars, vq = jax.jit(jenc.init)(jax.random.key(1), x0)
    feats = jax.jit(lambda v, x: jenc.module.apply(v, x, train=False))(enc_vars,
                                                                        jnp.asarray(image))
    vq = init_codebook_from_batch(jax.random.key(6), feats, vq)
    dec_vars = jax.jit(lambda k1, k2, q: jdec.init({"params": k1, "dropblock": k2}, q,
                                                   train=False))(
        jax.random.key(2), jax.random.key(3), jnp.zeros((1, SIZE, SIZE, worker.GAN_ENC[0])))
    s0 = jstate.create_train_state(jax.random.key(4), enc_vars, dict(dec_vars), vq, txs[0],
                                   txs[1], dis_vars=dis_vars, dis_tx=txs[2])
    if kind == "second":
        step = jss.make_second_stage_step(jenc, jdec, jdis, txs[1], txs[2], loss_cfg=sc,
                                          axis_name=DATA_AXIS)
        return SimpleNamespace(jcfg=jcfg, s0=s0, step=step, m=None)
    ds = jcfg.dataset
    mw = dict(dataset_window=(float(ds.window_width), float(ds.window_center),
                              float(ds.window_scale)),
              **{k: tuple(float(v) for v in getattr(jcfg.loss, k))
                 for k in ("recon_weights", "freq_weights", "percep_weights")},
              axis_name=DATA_AXIS)
    if kind == "mw_first":
        step = jmw.make_multi_window_first_stage_step(
            jenc, jdec, txs[0], txs[1], loss_cfg=fc, aug_cfg=jcfg.augmentation,
            dict_size=worker.GAN_DICT, **mw)
    elif kind == "mw_second":
        step = jmw.make_multi_window_second_stage_step(jenc, jdec, jdis, txs[1], txs[2],
                                                       loss_cfg=sc, **mw)
    else:
        step = jmw.make_joint_step(jenc, jdec, jdis, *txs, first_cfg=fc, second_cfg=sc,
                                   aug_cfg=jcfg.augmentation, dict_size=worker.GAN_DICT, **mw)
    return SimpleNamespace(jcfg=jcfg, s0=s0, step=step, m=None)


def port_weights(kind, s0):
    """The JAX initial state's modules under the port's keys."""
    s = _state_np(s0)
    if kind == "vqgan":
        return {"decoder": bridge.from_jax_vqgan(s.dec_vars, s.vq, vqgan_shape()),
                "discriminator": bridge.from_jax_discriminator(s.dis_vars)}
    return bridge.from_jax_train_state(s)


def rank_draws(kind, rng, aug_cfg, n_inner):
    """Each rank's draws of `kind`'s JAX step from its state key `rng`:
    the step's key splits, each folded with the rank (`per_device_keys`),
    in the port's layout."""
    fold = jax.random.fold_in
    if kind in ("second", "vqgan", "mw_second"):
        k_dis = jax.random.split(rng, 3)[2]
        n = 3 if kind == "mw_second" else n_inner
        return [cutmix_draws(fold(k_dis, r), SIZE, SIZE, n) for r in range(WORLD)]
    keys = jax.random.split(rng, 5 if kind == "mw_first" else 6)
    out = []
    for r in range(WORLD):
        views = tuple(to_torch_draws(jax_view_draws(fold(k, r), aug_cfg, B, SIZE, SIZE))
                      for k in keys[1:3])
        out.append(views if kind == "mw_first"
                   else (*views, cutmix_draws(fold(keys[5], r), SIZE, SIZE, 3)))
    return out


def run_jax_step(setup, mesh, image):
    with jax.default_matmul_precision("highest"):
        s1, metrics = data_parallel(setup.step, mesh)(replicate(mesh, setup.s0),
                                                      shard_batch(mesh, image))
    return _state_np(s1), {k: float(v) for k, v in metrics.items()}


def start_gan_ranks(root, kinds):
    """Write each kind's inputs and start the `gan` ranks on them: (the
    ranks, the JAX setups, the image)."""
    work = root / "gan"
    work.mkdir()
    image = images()
    setups = {kind: jax_setup(kind, image) for kind in kinds}
    inputs = {"kinds": list(kinds), "image": {}, "weights": {}, "draws": {}}
    for kind, st in setups.items():
        n_inner = jss.second_stage_config_from_json(st.jcfg.loss).n_inner_loops
        inputs["image"][kind] = torch.from_numpy(image)
        inputs["weights"][kind] = port_weights(kind, st.s0)
        inputs["draws"][kind] = rank_draws(kind, st.s0.rng, st.jcfg.augmentation, n_inner)
    torch.save(inputs, work / "gan.pt")
    return Ranks("gan", WORLD, work, str(root / "gan.init"), timeout=RANKS_TIMEOUT), setups, image


def jax_steps(setups, image):
    """Each kind's JAX data-parallel step from its initial state:
    {kind: (s0, s1, metrics)}."""
    mesh = create_mesh(jax.devices()[:WORLD])
    return {kind: (_state_np(st.s0), *run_jax_step(st, mesh, image))
            for kind, st in setups.items()}


# ---------------------------------------------------------------------------
# comparisons shared with the multi-window files
# ---------------------------------------------------------------------------
def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def limit(floor, base=BASE_RTOL):
    return max(5 * floor, base)


def jax_module(s, kind, part, params=None):
    """A JAX state's `part` under the port's keys; with `params` (a pytree
    in the module's parameter layout, e.g. Adam's first moment) in place
    of its parameters."""
    if part == "encoder":
        return bridge.from_jax_encoder({"params": params if params is not None
                                        else s.enc_vars["params"]}, s.vq)
    if part == "decoder" and kind == "vqgan":
        tree = {**s.dec_vars, **({"params": params} if params is not None else {})}
        return bridge.from_jax_vqgan(tree, s.vq, vqgan_shape())
    if part == "decoder":
        return bridge.from_jax_decoder({**s.dec_vars, **({"params": params}
                                                         if params is not None else {})})
    return bridge.from_jax_discriminator({**s.dis_vars, **({"params": params}
                                                           if params is not None else {})})


def jax_moments(s, kind, part):
    opt = getattr(s, worker.OPTS[part])
    mu = next(x for x in opt if hasattr(x, "mu")).mu
    return jax_module(s, kind, part, params=mu)


def _cat(sd, names):
    return torch.cat([sd[k].flatten() for k in names])


def moment_error(out, jax_s1, kind, part):
    """(port vs JAX, the port's floor run vs the port) relative Frobenius
    error of Adam's first moment after one step ((1 − β1)·g)."""
    names = sorted(out["run"]["state"][part + "_mu"])
    want = _cat(jax_moments(jax_s1, kind, part), names)
    got = _cat(out["run"]["state"][part + "_mu"], names)
    floor = _cat(out["floor"]["state"][part + "_mu"], names)
    return _rel(got, want), _rel(floor, got)


def delta_mismatch(out, jax_s0, jax_s1, kind, part, lr):
    """The fraction of `part`'s parameters whose one-step update is more
    than 1e-3·lr from JAX's, and the floor run's from the port's."""
    names = sorted(out["run"]["state"][part + "_mu"])
    start = _cat(jax_module(jax_s0, kind, part), names)
    jax_d = _cat(jax_module(jax_s1, kind, part), names) - start
    got = _cat(out["run"]["state"][part], names) - start
    floor = _cat(out["floor"]["state"][part], names) - start

    def mismatch(d, ref):
        return float(((d - ref).abs() > 1e-3 * lr).float().mean())

    return mismatch(got, jax_d), mismatch(floor, got)


def metric_within(name, got, want):
    atol = {"consistency": 1e-6, "dist": 1e-3}.get(name, 0.0)
    return abs(got - want) <= atol + BASE_RTOL * abs(want)


def check_buffers(out, jax_s1, kind):
    """The discriminator's spectral-norm vectors within the floor's limit,
    the decoder's BatchNorm running stats and the codebook rtol 1e-4."""
    state, floor = out["run"]["state"], out["floor"]["state"]
    if "discriminator" in state:
        want = jax_module(jax_s1, kind, "discriminator")
        sn = [k for k in state["discriminator"] if k.endswith(("u0", "sv0"))]
        assert sn
        for k in sn:
            got = state["discriminator"][k]
            f = float((floor["discriminator"][k] - got).abs().max()) / max(
                float(got.abs().max()), 1e-12)
            tol = limit(f)
            np.testing.assert_allclose(got.numpy(), want[k].numpy(), rtol=tol,
                                       atol=1e-6 + tol, err_msg=k)
    codebook = "decoder" if kind == "vqgan" else "encoder"
    if codebook in state:
        want = jax_module(jax_s1, kind, codebook)
        for k in ("vq.embed", "vq.cluster_size", "vq.embed_avg"):
            np.testing.assert_allclose(state[codebook][k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    if kind != "vqgan":
        want = jax_module(jax_s1, kind, "decoder")
        keys = [k for k in state["decoder"] if k.endswith(("running_mean", "running_var"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(state["decoder"][k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def expected_collectives(kind, out):
    """The all-reduces a step of `kind` issues and their bytes (f32): each
    SPADE BatchNorm (2 a decoder level) once a decode forward and once
    backward with its (mean, mean of squares); the VQ counts and sums once
    a training encode; each optimizer's gradients once; the
    discriminator's gradients once an inner iteration (the multi-window
    steps: once, after every window), then its floating-point buffers
    once; the metrics once."""
    state = out["run"]["state"]
    n_params = {p: sum(t.numel() for t in state[p + "_mu"].values())
                for p in worker.MODULES[kind]}
    metrics = len(out["run"]["metrics"])
    n, nbytes = 1, metrics  # the metrics
    decodes = {"second": 1, "mw_first": 2, "mw_second": 1, "joint": 2, "vqgan": 0}[kind]
    bn_channels = 2 * sum(worker.GAN_DEC[:-1])  # each level's two norms
    n += decodes * 2 * 2 * (len(worker.GAN_DEC) - 1)
    nbytes += decodes * 2 * 2 * bn_channels
    encodes = {"mw_first": 2, "joint": 2, "vqgan": 1}.get(kind, 0)
    k, c = ((worker.VQGAN_KW["dict_size"], worker.VQGAN_KW["emb_dim"]) if kind == "vqgan"
            else (worker.GAN_DICT, worker.GAN_ENC[0]))
    n += encodes
    nbytes += encodes * k * (1 + c)
    for part in ("encoder", "decoder"):
        if part in n_params:
            n += 1
            nbytes += n_params[part]
    if "discriminator" in n_params:
        # one inner iteration (the configs' n_inner_loops), then the buffers
        dis = n_params["discriminator"]
        floats = sum(v.numel() for v in state["discriminator"].values() if v.is_floating_point())
        n += 2
        nbytes += dis + (floats - dis)
    return {"all_reduce": n, "all_reduce_bytes": 4 * nbytes}


def check_step(outs, jax_out, kind, what, name=None):
    """One check of the whole step of `kind` on every rank."""
    s0, s1, jm = jax_out
    for r, out in enumerate(outs):
        run = out["run"]
        if what == "losses":
            assert set(run["metrics"]) == set(jm) == set(METRICS[kind])
            assert metric_within(name, run["metrics"][name], jm[name]), (
                r, name, run["metrics"][name], jm[name])
        elif what == "gradients":
            err, floor = moment_error(out, s1, kind, name)
            assert err <= limit(floor), (r, name, err, floor)
        elif what == "deltas":
            lr = float(getattr(load_port_cfg(kind), {"encoder": "enc_optim",
                                                      "decoder": "dec_optim",
                                                      "discriminator": "dis_optim"}[name]).lr)
            err, floor = delta_mismatch(out, s0, s1, kind, name, lr)
            assert err <= max(5 * floor, MAX_MISMATCH), (r, name, err, floor)
        elif what == "buffers":
            check_buffers(out, s1, kind)
        elif what == "collectives":
            assert run["collectives"] == expected_collectives(kind, out), r
            if "buffer_drift" in run:
                assert run["buffer_drift"] == 0
    if what == "ranks":
        equal_trees(outs[0]["run"]["state"], outs[1]["run"]["state"])
        assert outs[0]["run"]["metrics"] == outs[1]["run"]["metrics"]
        assert outs[0]["run"]["state"]["step"] == 1


def load_port_cfg(kind):
    from medical_image_editing_tpu_torch.utils.config import load_json

    return load_json(worker.CONFIGS[kind])


def step_cases(kinds):
    """(kind, what, name) for every check of the whole steps of `kinds`."""
    out = []
    for kind in kinds:
        out += [(kind, "losses", n) for n in METRICS[kind]]
        for what in ("gradients", "deltas"):
            out += [(kind, what, p) for p in worker.MODULES[kind]]
        out += [(kind, w, None) for w in ("buffers", "collectives", "ranks")]
    return out


def case_id(case):
    return "-".join(str(c) for c in case if c is not None)


# ---------------------------------------------------------------------------
# each collective on its own
# ---------------------------------------------------------------------------
def _pieces(rng, vqgan_vars, vq):
    """ActNorm, PatchGAN, VQGAN and inner-loop inputs; the JAX PatchGAN's
    initial variables."""
    f32 = np.float32
    c = 6
    x = {"an_x": (2 + 3 * rng.normal(size=(WORLD * 2, 5, 5, c))).astype(f32),
         "an_loc": np.linspace(-0.2, 0.3, c).astype(f32),
         "an_scale": np.linspace(0.5, 1.5, c).astype(f32),
         "pg_x": images(31), "pg_fake": images(32), "vq_x": images(33)}
    jm = JNLayer(n_filters=4, n_layers=2, normalization="batchnorm", apply_spectral_norm=True,
                 axis_name=DATA_AXIS)
    pg_vars = jax.jit(lambda k: jm.init(k, jnp.zeros((1, SIZE, SIZE, 1)), train=False))(
        jax.random.key(9))
    shape = jax.eval_shape(lambda v: jm.apply(v, jnp.zeros((1, SIZE, SIZE, 1)), False),
                           pg_vars).shape
    x["pg_t"] = rng.normal(size=(WORLD * B,) + shape[1:]).astype(f32)
    torch_in = {k: torch.from_numpy(v) for k, v in x.items()}
    torch_in["patchgan"] = bridge.from_jax_discriminator(_np(pg_vars))
    torch_in["vqgan"] = bridge.from_jax_vqgan(_np(vqgan_vars), _np(vq), vqgan_shape())
    return x, torch_in, jm, pg_vars


def _jax_pieces(mesh, x, jm, pg_vars, vqgan_vars, vq, dis_optim):
    gather = lambda t: jax.lax.all_gather(t, DATA_AXIS, tiled=True)  # noqa: E731
    out = {}
    an = JActNorm(x["an_x"].shape[-1], axis_name=DATA_AXIS)
    an_vars = an.init(jax.random.key(0), jnp.asarray(x["an_x"]), train=False)
    params = {"loc": x["an_loc"], "scale": x["an_scale"]}

    def an_fn(coll, xs):
        y, upd = an.apply({"params": params, "actnorm": coll}, xs, train=True,
                          mutable=["actnorm"])
        return gather(y), upd["actnorm"]

    out["actnorm"] = data_parallel(an_fn, mesh, n_state_args=1)(an_vars["actnorm"],
                                                               x["an_x"])

    def pg_fn(variables, xs, ts):
        p, extra = jss._split_vars(variables)

        def loss(pp, xx):
            y, upd = jm.apply({"params": pp, **extra}, xx, True, mutable=list(extra))
            return jnp.mean(y * ts), (y, upd)

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(p, xs)
        return gather(y), gather(gx), jax.lax.pmean(gp, DATA_AXIS), upd

    out["patchgan"] = data_parallel(pg_fn, mesh, n_state_args=1)(pg_vars, x["pg_x"],
                                                                 x["pg_t"])

    m = jvqgan.VQGAN(**{**worker.VQGAN_KW, "knn_backend": "xla"}, axis_name=DATA_AXIS)

    def vq_fn(variables, st, xs):
        recon, commit, ids, _, new_vq = m.apply(variables, xs, st, True)
        return gather(recon), gather(ids), new_vq

    out["vqgan"] = data_parallel(vq_fn, mesh, n_state_args=2)(vqgan_vars, vq, x["vq_x"])

    tx = jstate.make_optimizer_from_config(dis_optim)

    def loop_fn(variables, xs, fake):
        p, extra = jss._split_vars(variables)
        opt = tx.init(p)
        losses = []
        for _ in range(2):
            def loss(pp, extra=extra):
                r, e1 = jss._apply(jm, pp, extra, xs, True)
                f, e2 = jss._apply(jm, pp, e1, fake, True)
                return hinge_d_loss(r, f), e2

            (lv, extra), g = jax.value_and_grad(loss, has_aux=True)(p)
            g = jax.lax.pmean(g, DATA_AXIS)
            upd, opt = tx.update(g, opt, p)
            p = optax.apply_updates(p, upd)
            losses.append(lv)
        extra = jax.lax.pmean(extra, DATA_AXIS)
        mu = next(s for s in opt if hasattr(s, "mu")).mu
        return {"params": p, **extra}, mu, jax.lax.all_gather(losses[-1], DATA_AXIS)

    with jax.default_matmul_precision("highest"):
        out["inner_loop"] = data_parallel(loop_fn, mesh, n_state_args=1)(
            pg_vars, x["pg_x"], x["pg_fake"])
    return _np(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the rank processes, then computes the JAX side while they run."""
    root = tmp_path_factory.mktemp("gan_ranks")
    pieces_dir = root / "pieces"
    pieces_dir.mkdir()
    rng = np.random.default_rng(5)
    m = jvqgan.VQGAN(**{**worker.VQGAN_KW, "knn_backend": "xla"}, axis_name=DATA_AXIS)
    vq = vq_init(jax.random.key(43), worker.VQGAN_KW["dict_size"], worker.VQGAN_KW["emb_dim"])
    vqgan_vars = jax.jit(lambda k: m.init(k, jnp.zeros((1, SIZE, SIZE, 1)), vq, train=False))(
        jax.random.key(2))
    x, torch_in, jm, pg_vars = _pieces(rng, vqgan_vars, vq)
    torch.save(torch_in, pieces_dir / "gan_pieces.pt")
    started = [Ranks("gan_pieces", WORLD, pieces_dir, str(root / "pieces.init"),
                     timeout=RANKS_TIMEOUT)]
    try:
        steps, setups, image = start_gan_ranks(root, KINDS)
        started.append(steps)
        mesh = create_mesh(jax.devices()[:WORLD])
        jax_pieces = _jax_pieces(mesh, x, jm, pg_vars, vqgan_vars, vq,
                                 jload_json(worker.CONFIGS["second"]).dis_optim)
        jax_out = jax_steps(setups, image)
    except BaseException:
        for r in started:
            r.kill()
        raise
    return SimpleNamespace(pieces=started[0], x=x, jax=jax_pieces, steps=steps,
                           jax_steps=jax_out, pg_vars=_np(pg_vars))


def _rows(a, r, n=B):
    return np.asarray(a)[r * n:(r + 1) * n]


def test_actnorm_data_init_averages_each_ranks_statistics_like_jax(ranks):
    y, coll = ranks.jax["actnorm"]
    for r, out in enumerate(ranks.pieces.results()):
        an = out["actnorm"]
        np.testing.assert_allclose(an["y"].numpy(), _rows(y, r), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(an["data_loc"].numpy(), coll["data_loc"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(an["data_scale"].numpy(), coll["data_scale"], rtol=1e-5,
                                   atol=1e-6)
        assert an["initialized"] == 1
        assert an["collectives"] == {"all_reduce": 1, "all_reduce_bytes": 4 * 2 * 6}


@pytest.mark.parametrize("part", ["logits", "input_grad", "param_grads", "state"])
def test_patchgan_synced_batch_norm_matches_jax(ranks, part):
    y, gx, gp, upd = ranks.jax["patchgan"]
    for r, out in enumerate(ranks.pieces.results()):
        pg = out["patchgan"]
        if part == "logits":
            np.testing.assert_allclose(pg["logits"].numpy(), _rows(y, r), rtol=1e-4, atol=1e-6)
        elif part == "input_grad":
            np.testing.assert_allclose(pg["dx"].numpy(), _rows(gx, r), rtol=1e-4, atol=1e-6)
        elif part == "param_grads":
            want = bridge.from_jax_discriminator({"params": gp, **upd})
            assert set(pg["grads"]) <= set(want)
            for k, g in pg["grads"].items():
                np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
        else:
            want = bridge.from_jax_discriminator({"params": ranks.pg_vars["params"], **upd})
            keys = [k for k in want if k.endswith(("running_mean", "running_var", "weight_u"))]
            assert len([k for k in keys if k.endswith("running_mean")]) == 2
            for k in keys:
                np.testing.assert_allclose(pg["state"][k].numpy(), want[k].numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def test_vqgan_averages_its_codebook_statistics_like_jax(ranks):
    recon, ids, new_vq = ranks.jax["vqgan"]
    for r, out in enumerate(ranks.pieces.results()):
        v = out["vqgan"]
        np.testing.assert_array_equal(v["ids"].numpy(), _rows(ids, r))
        got = _rows(recon, r)
        np.testing.assert_allclose(v["recon"].numpy(), got, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(got).max()))
        embed, cluster, avg = (t.numpy() for t in v["vq"])
        np.testing.assert_allclose(embed, new_vq.embed, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(cluster, new_vq.cluster_size, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(avg, new_vq.embed_avg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("part", ["losses", "moments", "updates", "buffers", "collectives"])
def test_inner_loop_averages_gradients_and_buffers_like_jax(ranks, part):
    """Two iterations of the PatchGAN's inner loop (batch norm, spectral
    norm): each iteration's gradients averaged before Adam, the buffers
    after the loop."""
    variables, mu, losses = ranks.jax["inner_loop"]
    want = bridge.from_jax_discriminator(variables)
    want_mu = bridge.from_jax_discriminator({**variables, "params": mu})
    start = bridge.from_jax_discriminator(ranks.pg_vars)
    lr = float(jload_json(worker.CONFIGS["second"]).dis_optim.lr)
    outs = ranks.pieces.results()
    for r, out in enumerate(outs):
        loop = out["inner_loop"]
        names = sorted(loop["mu"])
        if part == "losses":
            assert abs(loop["dis"] - float(losses[r])) <= BASE_RTOL * abs(float(losses[r]))
        elif part == "moments":
            assert _rel(_cat(loop["mu"], names), _cat(want_mu, names)) <= BASE_RTOL
        elif part == "updates":
            got = _cat(loop["state"], names) - _cat(start, names)
            ref = _cat(want, names) - _cat(start, names)
            assert float(((got - ref).abs() > 1e-3 * lr).float().mean()) <= MAX_MISMATCH
        elif part == "buffers":
            keys = [k for k in want if k.endswith(("running_mean", "running_var", "weight_u"))]
            assert keys
            for k in keys:
                np.testing.assert_allclose(loop["state"][k].numpy(), want[k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
            assert loop["buffer_drift"] == 0
        else:
            # an iteration: 2 forwards × 2 norms, each once forward and once
            # backward, then the gradients; after the loop the buffers
            n_params = sum(t.numel() for t in loop["mu"].values())
            n_bufs = sum(t.numel() for t in loop["state"].values()
                         if t.is_floating_point()) - n_params
            bn = 2 * (8 + 16)  # a forward's (mean, mean²) of the 8- and 16-channel norms
            assert loop["collectives"] == {
                "all_reduce": 2 * (2 * 2 * 2 + 1) + 1,
                "all_reduce_bytes": 4 * (2 * (2 * 2 * bn + n_params) + n_bufs)}
    equal_trees(outs[0]["inner_loop"]["state"], outs[1]["inner_loop"]["state"])


# ---------------------------------------------------------------------------
# the whole steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", step_cases(KINDS), ids=case_id)
def test_step_matches_jax_data_parallel(ranks, case):
    kind, what, name = case
    check_step([out[kind] for out in ranks.steps.results()], ranks.jax_steps[kind], kind,
               what, name)

