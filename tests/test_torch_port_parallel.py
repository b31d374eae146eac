"""Data-parallel first-stage training (ROADMAP 15(i)): two ranks of the port
against the JAX package's `parallel.data_parallel` over two CPU devices on
the concatenated batch, each collective on its own before the whole step.

The ranks are two gloo processes (`tests/torch_parallel_worker.py`, torch
and the port only) started with `torch.multiprocessing`'s spawn context and
a `file://` rendezvous in a tmp dir, so that no TCP port is shared between
test workers; each spawn is joined with its own timeout of `TIMEOUT`
seconds, so a hang fails its tests. The ranks take their inputs from files
this module writes (numpy arrays from seeds, the flax-initialised weights
through the port's weight bridge, the draws replayed from the JAX keys);
JAX runs here, on `jax.devices()[:2]` of the conftest's virtual CPU
devices, while the ranks run. Rank r holds rows [r·B, (r+1)·B) of each
input, JAX's `P('data')` layout.

Tolerances, float32:
* `pmean`: exact (the mean of two values is their sum halved on both sides).
* the synced batch norm (forward, running stats, input gradients and the
  averaged scale and bias gradients): rtol 1e-5, atol 1e-6 (four ulps at
  |y| ~ 2) — sums of at most 50 terms in other orders.
* `quantize`: the same ids on each rank; the averaged counts exact (an
  average of two integer counts), the averaged sums and the EMA rtol 1e-5,
  atol 1e-6.
* the gathered k-means (the start rows from the JAX key): rtol 1e-4, atol
  1e-5, as `tests/test_torch_port_train.py`.
* the whole step (k-means, then one step with each rank's draws from
  `jax_view_draws(fold_in(k, r))`, JAX's `per_device_keys`): the
  tolerances of `tests/test_torch_port_train.py`: losses, the codebook
  after k-means and the VQ EMA state rtol 1e-4 (the distance loss atol
  1e-3), the SPADE BatchNorms' running stats rtol 1e-4 atol 1e-6, and the
  gradients and one-step parameter deltas within 5× the route floor: the
  disagreement between the JAX data-parallel step's two conv routes
  (`packed`, `xla`), which compute the same function in another summation
  order. Measured here: encoder gradients 6.1e-2 from JAX's against a
  floor of 1.6e-2, decoder 3.1e-6 against 1.1e-4; steps that differ 2.2%
  of the encoder's parameters against 0.93%, 0.16% of the decoder's
  against 0.17%. The two ranks' states (modules, Adam states, generator)
  are bit for bit equal, and the step issues exactly the collectives it
  should.

Port only: a one-rank group (made from a torchrun-style environment by
`initialize_distributed`) trains bit for bit as no group; the loader gives
every rank as many full batches (fault C.5); `run_vqwnet.main` on two ranks
writes one run directory from rank 0, resumes bit for bit, tests, and
does the same for the three GAN trainers (item 15(ii): the second stage,
staged from a first stage, whose step-0 k-means gathers both ranks' rows;
`-w` in `joint_step`; `-v`). The volumetric CLIs on two ranks (item
15(iii)) are held in `tests/test_torch_port_volumetric_spatial.py`.
"""

import json
import os
import time
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.models.unet_encoder import init_codebook_from_batch
from medical_image_editing_tpu.ops.vq import VQState as JVQState
from medical_image_editing_tpu.ops.vq import vq_apply
from medical_image_editing_tpu.parallel import (
    DATA_AXIS,
    create_mesh,
    data_parallel,
    replicate,
    shard_batch,
)
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.utils.config import load_json as jload_json
from medical_image_editing_tpu_torch.data.loader import DataLoader
from medical_image_editing_tpu_torch.utils import weights as bridge
from test_torch_port_augment import jax_view_draws, to_torch_draws
from test_torch_port_train import _disagreement, _step_mismatch

TIMEOUT = 120  # seconds from a spawn's start to its ranks' exit
GAN_CLI_TIMEOUT = 400  # the three GAN trainers' runs on two ranks
GAN_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
GAN_CLI = {"second_step": ("lung_second_stage.json", []),
           "multi_window": ("lung_multiwindow_joint.json", ["-w"]),
           "vqgan": ("crc_vqgan.json", ["-v"])}
WORLD = 2
B, SIZE = 2, 32  # rows a rank, side
ENC, DEC, DICT = worker.ENC, worker.DEC, worker.DICT


class Ranks:
    """The `world` rank processes of one task of `torch_parallel_worker`."""

    def __init__(self, task, world, workdir, init, timeout=TIMEOUT):
        ctx = torch.multiprocessing.get_context("spawn")
        self.task, self.workdir, self.timeout = task, workdir, timeout
        self.procs = [ctx.Process(target=worker.run, args=(r, world, init, task, str(workdir)))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self._out = None

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()

    def results(self):
        """Each rank's saved outputs, after all exited 0 within the timeout."""
        if self._out is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            hung = [i for i, p in enumerate(self.procs) if p.is_alive()]
            self.kill()
            assert not hung, f"{self.task}: ranks {hung} still running after {self.timeout} s"
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * len(codes), f"{self.task}: exit codes {codes}"
            self._out = [torch.load(os.path.join(self.workdir, f"{self.task}-{r}.pt"),
                                    weights_only=True) for r in range(len(self.procs))]
        return self._out


def crc_tree(root, n_patients=2, n_slices=5, size=SIZE, seed=0):
    """`root/patNN/slice_SSSS.npy`: smooth 0-255 slices with a blob, as the
    VQGAN trainer tests write them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for p in range(n_patients):
        d = root / f"pat{p:02d}"
        d.mkdir(parents=True)
        for s in range(n_slices):
            img = 60 + 80 * yy + 100 * np.exp(
                -((yy - rng.uniform(0.3, 0.7)) ** 2 + (xx - rng.uniform(0.3, 0.7)) ** 2) / 0.02)
            np.save(d / f"slice_{s:04d}.npy",
                    np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.float32))


def write_gan_cli(root):
    """The GAN trainers' configs at test widths over seeded slice trees (2
    patients × 5 slices: a rank's shard holds 2 batches of 2 an epoch), the
    first stage the second stage stages, and `gan_cli.json`."""
    worker.lung_tree(str(root / "lung"))
    crc_tree(root / "crc")
    stage = worker.cli_config(str(root), n_epochs=1)
    stage["dataset"]["root_dir_path"] = str(root / "lung")
    stage["save"]["study_name"] = "stage"
    json.dump(stage, open(root / "stage.json", "w"))
    for name, (config, flags) in GAN_CLI.items():
        cfg = json.load(open(os.path.join(GAN_CONFIGS, config)))
        cfg["dataset"].update(root_dir_path=str(root / ("crc" if name == "vqgan" else "lung")),
                              batch_size=2, num_workers=0, image_size=[SIZE, SIZE])
        cfg["model"]["vqmodel"].update(stage["model"]["vqmodel"])
        cfg["model"]["dis"].update(D_ch=2, resolution=128)
        if name == "vqgan":
            cfg["model"]["vqmodel"]["model_name"] = "VQGAN"
            cfg["model"]["vqgan"].update(
                mid_channels=4, emb_dim=8, dict_size=6, enc_ch_multiplier=[1, 2, 4],
                dec_ch_multiplier=[1, 2, 4], num_res_blocks=1, dec_attn_resolutions=[8],
                resolution=SIZE)
        cfg["save"].update(save_dir=str(root / "results"), study_name=name, n_save_images=2)
        cfg["run"].update(n_epochs=2, first_stage_ckpt_path=str(
            root / "results" / "stage" / "version_0" / "ckpt") if name == "second_step"
            else None)
        json.dump(cfg, open(root / f"{name}.json", "w"))
    json.dump({name: flags for name, (_, flags) in GAN_CLI.items()},
              open(root / "gan_cli.json", "w"))


def _pieces_inputs(rng):
    """pmean, batch norm, VQ and k-means inputs, WORLD·rows each."""
    embed = rng.normal(size=(5, 4)).astype(np.float32)
    vq_x = embed[rng.integers(0, 5, (WORLD * 2, 3, 3))] + 0.3 * rng.normal(
        size=(WORLD * 2, 3, 3, 4))
    f32 = np.float32
    return {
        "a": rng.normal(size=(WORLD, 3, 4)).astype(f32),
        "b": rng.normal(size=(WORLD, 5)).astype(f32),
        "bn_x": (1.5 + 2 * rng.normal(size=(WORLD * 2, 5, 5, 6))).astype(f32),
        "bn_t": rng.normal(size=(WORLD * 2, 5, 5, 6)).astype(f32),
        "bn_scale": rng.uniform(0.5, 1.5, 6).astype(f32),
        "bn_bias": rng.normal(size=6).astype(f32),
        "vq_embed": embed, "vq_cluster": rng.uniform(0.5, 2.0, 5).astype(f32),
        "vq_avg": rng.normal(size=(5, 4)).astype(f32), "vq_x": vq_x.astype(f32),
        "km_x": rng.normal(size=(WORLD * 2, 4, 4, 4)).astype(f32),
    }


def _images(seed=21):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    imgs = []
    for _ in range(WORLD * B):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.05, 0.1), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img + 0.3 * rng.normal(size=img.shape), -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def _np(state):
    return SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                              for f in ("enc_vars", "dec_vars", "vq", "enc_opt", "dec_opt")})


def _jax_pieces(mesh, x):
    """The JAX oracle of each collective, on the concatenated rows."""
    out = {}
    pm = data_parallel(lambda a, b: (jax.lax.pmean(a, DATA_AXIS), jax.lax.pmean(b, DATA_AXIS)),
                       mesh, n_state_args=0)
    out["pmean"] = pm(x["a"].reshape(-1, 4), x["b"].reshape(-1))

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis_name=DATA_AXIS)

    def bn_fn(params, stats, xs, ts):
        def loss(p, xx):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
            return jnp.mean(y * ts), (y, upd["batch_stats"])

        (_, (y, new)), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(params, xs)
        gather = lambda t: jax.lax.all_gather(t, DATA_AXIS, tiled=True)  # noqa: E731
        return gather(y), gather(gx), jax.lax.pmean(gp, DATA_AXIS), new

    c = x["bn_x"].shape[-1]
    out["bn"] = data_parallel(bn_fn, mesh, n_state_args=2)(
        {"scale": x["bn_scale"], "bias": x["bn_bias"]},
        {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}, x["bn_x"], x["bn_t"])

    state = JVQState(x["vq_embed"], x["vq_cluster"], x["vq_avg"])
    out["vq"] = {}
    for m in (0.0, 0.99):
        fn = data_parallel(lambda st, xs, m=m: vq_apply(st, xs, momentum=m, train=True,
                                                       axis_name=DATA_AXIS)[3],
                           mesh, n_state_args=1)
        out["vq"][m] = fn(state, x["vq_x"])
    km = data_parallel(lambda key, st, xs: init_codebook_from_batch(
        key, xs, st, axis_name=DATA_AXIS, num_iters=10), mesh, n_state_args=2)
    out["kmeans"] = km(jax.random.key(7), state, x["km_x"])
    return jax.tree.map(np.asarray, out)


def _jax_models():
    jcfg = jload_json(worker.CONFIG)
    jenc = JEncoder(filters=ENC, dict_size=DICT, momentum=float(jcfg.model.vqmodel.momentum),
                    knn_backend="pallas", axis_name=DATA_AXIS)
    jdec = JDecoder(out_channels=1, filters=DEC, dropped_skip_layers=(), use_pixel_shuffle=False,
                    axis_name=DATA_AXIS)
    enc_vars, vq = jax.jit(jenc.init)(jax.random.key(1), jnp.zeros((1, SIZE, SIZE, 1)))
    dec_vars = dict(jax.jit(jdec.init, static_argnames="train")(
        {"params": jax.random.key(2), "dropblock": jax.random.key(3)},
        jnp.zeros((1, SIZE, SIZE, ENC[0])), train=False))
    enc_tx = jstate.make_optimizer_from_config(jcfg.enc_optim)
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    s0 = jstate.create_train_state(jax.random.key(4), enc_vars, dec_vars, vq, enc_tx, dec_tx)
    return jcfg, jenc, jdec, enc_tx, dec_tx, s0


def _jax_steps(mesh, models, image):
    """k-means then one data-parallel step, on each conv route."""
    jcfg, jenc, jdec, enc_tx, dec_tx, s0 = models
    prev = os.environ.get("MEDIMG_CONV_IMPL")
    out = {}
    try:
        with jax.default_matmul_precision("highest"):
            s0 = replicate(mesh, s0)
            image = shard_batch(mesh, image)
            s1 = data_parallel(jfs.init_codebook_step(jenc, axis_name=DATA_AXIS), mesh)(
                s0, image)
            for route in ("packed", "xla"):
                os.environ["MEDIMG_CONV_IMPL"] = route
                step = data_parallel(jfs.make_first_stage_step(
                    jenc, jdec, enc_tx, dec_tx, loss_cfg=jfs.loss_config_from_json(jcfg.loss),
                    aug_cfg=jcfg.augmentation, dict_size=DICT, axis_name=DATA_AXIS), mesh)
                s2, metrics = step(s1, image)
                out[route] = (_np(s2), jax.tree.map(np.asarray, metrics))
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL", None)
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev
    out["s1"] = _np(s1)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the rank processes, then computes the JAX side while they run."""
    root = tmp_path_factory.mktemp("ranks")
    started = []
    try:
        cli_dir = root / "cli"
        worker.lung_tree(str(cli_dir / "data"))
        started.append(Ranks("cli", WORLD, cli_dir, str(root / "cli.init")))
        gan_dir = root / "gan_cli"
        write_gan_cli(gan_dir)
        started.append(Ranks("gan_cli", WORLD, gan_dir, str(root / "gan_cli.init"),
                             timeout=GAN_CLI_TIMEOUT))

        work = root / "main"
        work.mkdir()
        rng = np.random.default_rng(3)
        pieces = _pieces_inputs(rng)
        n_km = pieces["km_x"].shape[0] * 16
        pieces["km_idx"] = np.asarray(jax.random.choice(jax.random.key(7), n_km, (5,),
                                                        replace=False))
        np.savez(work / "pieces.npz", **pieces)
        models = _jax_models()
        s0 = models[-1]
        image = _images()
        # the keys of JAX's init_codebook_step and step: k-means rows from the
        # state's key, then each device's views from its folded-in keys
        rng_1, k_init = jax.random.split(s0.rng)
        init_idx = jax.random.choice(k_init, WORLD * B * SIZE * SIZE, (DICT,), replace=False)
        _, k1, k2, _, _ = jax.random.split(rng_1, 5)
        draws = [tuple(to_torch_draws(jax_view_draws(jax.random.fold_in(k, r),
                                                     models[0].augmentation, B, SIZE, SIZE))
                       for k in (k1, k2)) for r in range(WORLD)]
        weights = bridge.from_jax_train_state(_np(s0))
        torch.save({"weights": {k: weights[k] for k in ("encoder", "decoder")},
                    "image": torch.from_numpy(image),
                    "init_idx": torch.from_numpy(np.asarray(init_idx).copy()),
                    "draws": draws}, work / "step.pt")
        started.append(Ranks("main", WORLD, work, str(root / "main.init")))
        started.append(Ranks("one_rank", 1, work, "env"))

        mesh = create_mesh(jax.devices()[:WORLD])
        jax_pieces = _jax_pieces(mesh, pieces)
        jax_steps = _jax_steps(mesh, models, image)
    except BaseException:
        for r in started:
            r.kill()
        raise
    cli, gan_cli, main, one = started
    return SimpleNamespace(cli=cli, gan_cli=gan_cli, main=main, one=one, pieces=pieces,
                           jax=jax_pieces, steps=jax_steps, s0=_np(s0))


# ---------------------------------------------------------------------------
# each collective against JAX
# ---------------------------------------------------------------------------


def test_pmean_matches_jax(ranks):
    want = ranks.jax["pmean"]
    for out in ranks.main.results():
        for got, w in zip(out["pmean"], want):
            np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("part", ["forward", "running_stats", "input_grad", "param_grads"])
def test_synced_batch_norm_matches_jax(ranks, part):
    y, dx, gp, stats = ranks.jax["bn"]
    tol = dict(rtol=1e-5, atol=1e-6)
    for r, out in enumerate(ranks.main.results()):
        bn = out["bn"]
        rows = slice(r * 2, (r + 1) * 2)
        if part == "forward":
            np.testing.assert_allclose(bn["y"].numpy(), y[rows], **tol)
        elif part == "input_grad":
            np.testing.assert_allclose(bn["dx"].numpy(), dx[rows], **tol)
        elif part == "param_grads":
            np.testing.assert_allclose(bn["dscale"].numpy(), gp["scale"], **tol)
            np.testing.assert_allclose(bn["dbias"].numpy(), gp["bias"], **tol)
        else:
            np.testing.assert_allclose(bn["mean"].numpy(), stats["mean"], **tol)
            np.testing.assert_allclose(bn["var"].numpy(), stats["var"], **tol)
            assert int(bn["tracked"]) == 1


def test_quantize_averages_counts_and_sums_like_jax(ranks):
    outs = ranks.main.results()
    local = [out["vq_local_ids"].numpy() for out in outs]
    for out in outs:
        # momentum 0: the state holds the averaged statistics themselves
        embed, counts, sums = (t.numpy() for t in out["vq"][0.0])
        w_embed, w_counts, w_sums = ranks.jax["vq"][0.0]
        np.testing.assert_array_equal(counts, w_counts)
        local_counts = sum(np.bincount(ids.ravel(), minlength=5) for ids in local) / WORLD
        np.testing.assert_array_equal(counts, local_counts)
        np.testing.assert_allclose(sums, w_sums, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(embed, w_embed, rtol=1e-5, atol=1e-6)
        for got, want in zip(out["vq"][0.99], ranks.jax["vq"][0.99]):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_gathered_kmeans_matches_jax(ranks):
    for out in ranks.main.results():
        for got, want in zip(out["kmeans"], ranks.jax["kmeans"]):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_ranks_hold_bit_identical_states(ranks):
    r0, r1 = ranks.main.results()
    _equal_trees(r0["state"], r1["state"])
    _equal_trees(r0["metrics"], r1["metrics"])
    assert r0["state"]["step"] == 1


def test_step_issues_the_collectives_it_should(ranks):
    """Per step: each SPADE BatchNorm (2 a level) once a view forward and
    once backward, the VQ statistics once a view, the encoder's and the
    decoder's gradients once each, the metrics once."""
    out = ranks.main.results()[0]
    n_bn = 2 * (len(DEC) - 1)
    params = {side: sum(g.numel() for g in out[f"{side}_grads"].values())
              for side in ("enc", "dec")}
    channels = 2 * sum(DEC[:-1])  # each norm's (mean, mean of squares) a level
    assert out["collectives"] == {
        "all_reduce": 2 * 2 * n_bn + 2 + 2 + 1,
        "all_reduce_bytes": 4 * (2 * 2 * 2 * channels + 2 * DICT * (1 + ENC[0])
                                 + params["enc"] + params["dec"] + 8)}


def test_step_codebook_init_matches_jax(ranks):
    for out in ranks.main.results():
        for got, want in zip(out["vq_init"], ranks.steps["s1"].vq):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["total", "commit", "cross", "dist", "reg", "recon", "freq",
                                  "perceptual"])
def test_step_losses_match_jax(ranks, name):
    want = ranks.steps["packed"][1]
    for out in ranks.main.results():
        np.testing.assert_allclose(float(out["metrics"][name]), float(want[name]), rtol=1e-4,
                                   atol=1e-3 if name == "dist" else 1e-7)


def test_step_vq_state_and_batch_stats_match_jax(ranks):
    s2 = ranks.steps["packed"][0]
    want = bridge.from_jax_decoder(s2.dec_vars)
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 2 * (len(DEC) - 1)
    for out in ranks.main.results():
        enc = out["state"]["encoder"]
        for name, w in zip(("vq.embed", "vq.cluster_size"), (s2.vq.embed, s2.vq.cluster_size)):
            np.testing.assert_allclose(enc[name].numpy(), w, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(enc["vq.embed_avg"].numpy().T, s2.vq.embed_avg, rtol=1e-4,
                                   atol=1e-6)
        for k in keys:
            np.testing.assert_allclose(out["state"]["decoder"][k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def _jax_grads(s2, side, b1=0.9):
    g = jax.tree.map(lambda m: m / (1 - b1), getattr(s2, f"{side}_opt")[0].mu)
    if side == "enc":
        return bridge.from_jax_encoder({"params": g})
    sd = bridge.from_jax_decoder({"params": g, "batch_stats": s2.dec_vars["batch_stats"]})
    return {k: v for k, v in sd.items() if "param_free_norm" not in k}


def _jax_params(s2, side):
    return (bridge.from_jax_encoder(s2.enc_vars) if side == "enc"
            else bridge.from_jax_decoder(s2.dec_vars))


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_step_gradients_match_jax(ranks, side):
    want = _jax_grads(ranks.steps["packed"][0], side)
    floor = _disagreement(_jax_grads(ranks.steps["xla"][0], side), want)
    assert 0 < floor < 0.1
    for out in ranks.main.results():
        got = {k: g.numpy() for k, g in out[f"{side}_grads"].items()}
        assert sorted(got) == sorted(want)
        assert _disagreement(got, want) <= 5 * floor


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_step_parameter_deltas_match_jax(ranks, side):
    name = "encoder" if side == "enc" else "decoder"
    before = bridge.from_jax_encoder(ranks.s0.enc_vars) if side == "enc" else \
        bridge.from_jax_decoder(ranks.s0.dec_vars)
    want_after = _jax_params(ranks.steps["packed"][0], side)
    keys = sorted(ranks.main.results()[0][f"{side}_grads"])  # the parameters
    cfg = jload_json(worker.CONFIG)
    lr = float((cfg.enc_optim if side == "enc" else cfg.dec_optim).lr)

    def deltas(after):
        return {k: np.asarray(after[k]) - np.asarray(before[k]) for k in keys}

    want = deltas(want_after)
    floor = _step_mismatch(deltas(_jax_params(ranks.steps["xla"][0], side)), want, lr)
    for out in ranks.main.results():
        got = deltas({k: v.numpy() for k, v in out["state"][name].items()})
        assert max(np.abs(d).max() for d in got.values()) <= lr * (1 + 1e-3)
        assert _step_mismatch(got, want, lr) <= 5 * max(floor, 1e-3)


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------


def test_one_rank_group_is_bit_identical_to_no_group(ranks):
    (out,) = ranks.one.results()
    assert out["backend"] == "gloo" and tuple(out["world"]) == (0, 1)
    assert out["again"] is False  # a second call uses the group it finds
    _equal_trees(out["group"]["state"], out["none"]["state"])
    _equal_trees(out["group"]["metrics"], out["none"]["metrics"])
    assert out["group"]["state"]["step"] == 2


class _Slices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((4, 4), float(i), np.float32), "patient_id": "p",
                "slice_num": i}


@pytest.mark.parametrize("batch", [2, 4, 5])
def test_loader_gives_every_rank_the_same_full_batches(batch):
    """Fault C.5: 9 slices on 2 ranks. The train loader cuts the permutation
    to 8 before striding, so both ranks get as many full batches (at batch
    5 none: rank 0 had one before, rank 1 none); the shards are disjoint."""
    shards = []
    for rank in range(2):
        loader = DataLoader(_Slices(9), batch_size=batch, shuffle=True, drop_last=True, seed=1)
        loader._process_shard = (2, rank)
        _, specs = loader._batch_specs()
        assert len(specs) == len(loader) == 4 // batch
        shards.append([i for _, idx in specs for i in idx])
    assert not set(shards[0]) & set(shards[1])
    test = DataLoader(_Slices(9), batch_size=batch, shuffle=False, drop_last=False)
    test._process_shard = (2, 1)
    assert [i for _, idx in test._batch_specs()[1] for i in idx] == [1, 3, 5, 7]


def _csv(path):
    rows = open(path).read().splitlines()
    return [dict(zip(rows[0].split(","), r.split(","))) for r in rows[1:]]


def test_cli_on_two_ranks_writes_from_rank_0_and_resumes_bit_for_bit(ranks):
    outs = ranks.cli.results()
    run = outs[0]["save_dir"]
    assert sorted(os.listdir(run)) == [f"version_{i}" for i in range(4)]
    straight, split, resumed, tested = (os.path.join(run, f"version_{i}") for i in range(4))
    a = _csv(os.path.join(straight, "log.csv"))
    b = _csv(os.path.join(split, "log.csv")) + _csv(os.path.join(resumed, "log.csv"))
    assert [float(r["iteration"]) for r in a] == [1, 2, 3, 4]
    assert a == b
    final = "ckpt-epoch=0001-step=00000004"
    assert sorted(os.listdir(os.path.join(straight, "ckpt"))) == ["ckpt-epoch=0000", final]
    sa, sb = (torch.load(os.path.join(p, "ckpt", final, "state.pt"), weights_only=True)
              for p in (straight, resumed))
    _equal_trees(sa, sb)
    assert {"config.json", "result.csv"} <= set(os.listdir(tested))
    assert json.load(open(os.path.join(straight, "config.json")))["seed_list"] == [42]


@pytest.mark.parametrize("what", sorted(GAN_CLI))
def test_gan_trainers_train_on_two_ranks_and_resume_bit_for_bit(ranks, what):
    """`run_vqwnet` trains each GAN trainer on two ranks (ROADMAP 15(ii)):
    one run directory a run, from rank 0 alone; 1 step and a resume to 2
    log and save what 2 steps straight do, bit for bit. The second stage
    stages a first stage and its step-0 k-means re-clusters the staged
    codebook over both ranks' first batches: the same codebook on both.
    `-w -m test` exports rank 0's shard of the test set from rank 0."""
    outs = ranks.gan_cli.results()
    run = outs[0][what]
    assert outs[1][what] == run
    runs = 4 if what == "multi_window" else 3  # `-m test` logs to a fourth
    assert sorted(os.listdir(run)) == [f"version_{i}" for i in range(runs)]
    straight, split, resumed = (os.path.join(run, f"version_{i}") for i in range(3))
    a = _csv(os.path.join(straight, "log.csv"))
    b = _csv(os.path.join(split, "log.csv")) + _csv(os.path.join(resumed, "log.csv"))
    assert [float(r["iteration"]) for r in a] == [1, 2]
    assert a == b and all(np.isfinite(float(r["total"])) for r in a)
    final = "ckpt-epoch=0000-step=00000002"
    sa, sb = (torch.load(os.path.join(p, "ckpt", final, "state.pt"), weights_only=True)
              for p in (straight, resumed))
    _equal_trees(sa, sb)
    assert "discriminator" in sa and sa["step"] == 2
    kmeans = [out["kmeans"][what] for out in outs]
    if what == "vqgan":  # the VQGAN's codebook starts random, as in JAX
        assert kmeans == [[], []]
    else:
        assert [len(k) for k in kmeans] == [1, 1]
        assert torch.equal(kmeans[0][0], kmeans[1][0])
    if what == "multi_window":  # rank 0 exports its strided shard: 5 of the 10 slices
        results = os.path.dirname(run)
        files = [f for d in os.listdir(results) if d.startswith("pat")
                 for f in os.listdir(os.path.join(results, d))]
        assert {p: sum(f.startswith(p) for f in files)
                for p in ("image_", "recon_", "label_")} == {"image_": 5, "recon_": 5,
                                                             "label_": 5}
    if what == "second_step":
        staged = torch.load(os.path.join(os.path.dirname(run), "stage", "version_0", "ckpt",
                                         "ckpt-epoch=0000-step=00000001", "state.pt"),
                            weights_only=True)
        assert not torch.equal(kmeans[0][0], staged["encoder"]["vq.embed"])
        assert torch.equal(sa["encoder"]["vq.embed"], kmeans[0][0])  # frozen after
