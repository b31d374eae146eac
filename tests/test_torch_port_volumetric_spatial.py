"""Volumetric depth sharding (ROADMAP 15(iii), first half): the port's
`make_volumetric_train_step(mesh=)`, `make_volumetric_edit_fn(mesh=)` and
the two CLIs on 1 × 2 and 2 × 2 meshes of gloo ranks, held to the JAX
package's unsharded step and decode (as `tests/test_volumetric.py` holds
its GSPMD runs to them) and to the port's own unsharded runs.

Sizes of the JAX tests: filters (4, 8, 16), `dict_size` 5, volumes
(2, 16, 16, 16, 1). Both sides start from the same flax-initialised
weights (`utils/weights.py::from_jax_volumetric`) and the same numpy
volumes from seeds. The ranks are spawned once for the module
(`tests/torch_spatial_worker.py`, torch and the port only; a `file://`
rendezvous in a tmp dir; each spawn joined within `TIMEOUT` seconds): two
ranks for the 1 × 2 mesh (the layers, the steps, bf16 with remat, the
decode, the refusals, the CLIs), four for 2 × 2 (the steps, the planted
averaged VQ statistics). JAX and the port's unsharded runs go in this
process while they run.

Tolerances:
* the halo conv and the sharded instance norm (f32): outputs and input
  gradients rtol 1e-5 (atol 1e-5 × the largest magnitude), the conv's
  weight and bias gradients (the ranks' parts summed) rtol 1e-5;
* the steps' first step against JAX (`tests/test_volumetric.py`'s own
  tolerances): losses and `cluster_size` rtol 1e-4, `embed` rtol 1e-3
  atol 1e-5; against the port's unsharded step the same; the gradients
  (Adam's first moment) within `limit(floor)` = min(max(5 × floor, 1e-4),
  0.5) (relative Frobenius norm), the floor measured in this run as in
  `tests/test_torch_port_volumetric.py` (the port's unsharded step
  perturbed at the rounding level; the encoder's reaches the cap);
* the ranks of a mesh: parameters, Adam's moments and steps, gradients
  and codebook bit for bit equal after each of two steps;
* bf16 with remat on 1 × 2 against the port's unsharded bf16 remat step:
  losses rtol 2⁻⁷ (two bf16 ulps), codebook rtol 2⁻⁶ of its largest
  value, each module's weight gradients together within BF16_GRAD_NOISE ×
  the unsharded bf16 step's own distance from its f32 step;
* the decode: atol and rtol 1e-4 of JAX's f32 decode; uint8 equal to JAX's
  decode truncated the same way wherever that decode lies more than
  1e-4·127.5 from a truncation boundary or is clipped, within one level
  elsewhere;
* the CLIs on two ranks against their unsharded runs in this process (three
  steps, so these hold gross faults only: Adam's first step is ±lr
  wherever |g| ≫ 1e-8, and elements whose gradient differs at the
  rounding level turn, which moves the later steps as
  `tests/test_torch_port_volumetric.py` describes): the first step line
  within 2e-4 (printed to 4 decimals), the later ones rtol 1e-2 (read:
  1.5e-3), one checkpoint with the same keys, its codebook's
  `cluster_size` rtol 1e-2 (read: 2.1e-3, a few voxels' codes) and its
  weights within 2·lr a step; the panel's input half equal to the
  unsharded run's, and the panel within one level of the unsharded forward
  of the checkpoint the mesh run wrote (the unsharded run's own recon
  half differs by up to 72 levels where a voxel's code turned);
  `edit_volume --partition spatial` on that checkpoint within 1e-4 of the
  unsharded decode (uint8: within one level).

Readings (CPU, this suite's host): halo conv 0 / 4.8e-7 abs, norm 7.5e-8
/ 9.0e-8 relative; step 1 against the port's unsharded step: losses
≤ 7.8e-8, `cluster_size` exact, `embed` 1.2e-12, gradients encoder
4.3e-2 (1 × 2) and 5.9e-2 (2 × 2), decoder 8.5e-7; decode 1.7e-6 abs.
The averaged statistics leave `cluster_size` 0.75 off on 2 × 2 (and
`embed` only 4.7e-6: the EMA's normalization cancels the factor).
"""

import contextlib
import io
import os
import re
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_worker as worker
from medical_image_editing_tpu.cli import edit_volume as jedit
from medical_image_editing_tpu_torch.cli import edit_volume as tedit
from medical_image_editing_tpu_torch.cli import train_volumetric as ttrain
from medical_image_editing_tpu_torch.models import volumetric as tvol
from medical_image_editing_tpu_torch.ops.vq import VQState
from medical_image_editing_tpu_torch.parallel import mesh as pmesh
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file
from test_torch_port_volumetric import _jax_init, _rel, _run_jax, _run_port, _vol, limit

SHAPE = (2, 16, 16, 16, 1)
K, LR = worker.K, worker.LR
TIMEOUT = 150  # seconds from a spawn's start to its ranks' exit
BF16_LOSS_RTOL = 2.0**-7
BF16_CODEBOOK_RTOL = 2.0**-6
BF16_GRAD_NOISE = 1.5
TRAIN_ARGV = ["--steps", "3", "--batch", "2", "--size", "16", "--n-synthetic", "4",
              "--filters", "4,8,16", "--dict-size", str(K), "--log-every", "1",
              "--device", "cpu"]


class Ranks:
    """The `world` rank processes of one task of `torch_spatial_worker`."""

    def __init__(self, task, world, workdir):
        ctx = torch.multiprocessing.get_context("spawn")
        self.task, self.workdir = task, workdir
        init = str(workdir / f"{task}.init")
        self.procs = [ctx.Process(target=worker.run, args=(r, world, init, task, str(workdir)))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + TIMEOUT
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
            assert not hung, f"{self.task}: ranks {hung} still running after {TIMEOUT} s"
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * len(codes), f"{self.task}: exit codes {codes}"
            self._out = [torch.load(os.path.join(self.workdir, f"{self.task}-{r}.pt"),
                                    weights_only=False) for r in range(len(self.procs))]
        return self._out


def _inputs(ji, work):
    rng = np.random.default_rng(11)
    sd = bridge.from_jax_volumetric(ji.ev, ji.dv, ji.vq)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    conv = tvol.Conv3d(3, 5, 3, padding=1)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(f32(*p.shape) * 0.2)
    labels = work / "labels"
    labels.mkdir()
    for i in range(3):  # three volumes in batches of two: a padded tail
        ids = rng.integers(0, K + 1, SHAPE[1:4]).astype(np.int32)
        np.save(labels / f"v{i}.npy", ids)
    ids = rng.integers(0, K + 1, SHAPE[:4]).astype(np.int32)
    ids[1, :8] = 0  # a volume whose first depth block is all background
    return {"shape": SHAPE, "weights": {"enc": sd["enc"], "dec": sd["dec"]},
            "vq": [torch.tensor(np.asarray(a)) for a in ji.vq],
            "vols": [_vol(21, SHAPE), _vol(22, SHAPE)],
            "layer_x": f32(2, 3, 8, 6, 5), "layer_g": f32(2, 5, 8, 6, 5),
            "layer_conv": conv.state_dict(),
            "norm_x": f32(2, 3, 8, 6, 5) * 3.0 + 0.5, "norm_g": f32(2, 3, 8, 6, 5),
            "ids": ids, "train_argv": TRAIN_ARGV,
            "edit_argv": ["--ckpt", str(work / "train_mesh" / "volumetric_ckpt"),
                          "--labels", str(labels), "--filters", "4,8,16", "--dict-size",
                          str(K), "--batch", "2", "--device", "cpu"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts both spawns, then computes the JAX side and the port's
    unsharded runs while they run."""
    work = tmp_path_factory.mktemp("spatial")
    ji = _jax_init(SHAPE)
    inputs = _inputs(ji, work)
    torch.save(inputs, work / "inputs.pt")
    started = []
    n = torch.get_num_threads()
    try:
        started.append(Ranks("two", 2, work))
        started.append(Ranks("four", 4, work))
        torch.set_num_threads(2)
        vols = inputs["vols"]
        jax_steps = _run_jax(ji, vols[:1])
        port = _run_port(ji, vols[:1])
        floor = _run_port(ji, vols[:1], floor=True)
        bf16 = _run_port(ji, vols[:1], dtype=torch.bfloat16, use_remat=True)
        jax_decode = np.asarray(jedit.make_volumetric_edit_fn(ji.dec)(
            ji.dv, ji.vq, jnp.asarray(inputs["ids"])))
        out = work / "train_alone"
        with contextlib.redirect_stdout(io.StringIO()) as stdout:
            assert ttrain.main(TRAIN_ARGV + ["--out", str(out)]) == 0
    except BaseException:
        for r in started:
            r.kill()
        raise
    finally:
        torch.set_num_threads(n)
    return SimpleNamespace(work=work, inputs=inputs, two=started[0], four=started[1],
                           jax=jax_steps[0], port=port[0], floor=floor[0], bf16=bf16[0],
                           jax_decode=jax_decode, train_alone=out,
                           train_alone_steps=_steps(stdout.getvalue()))


def _steps(stdout):
    """The step lines' losses, {name: value} a line."""
    return [{k: float(v) for k, v in (kv.split("=") for kv in ln.split(": ")[1].split())}
            for ln in stdout.splitlines() if ln.startswith("step ")]


def _joined(parts, key, axis=2):
    return torch.cat([p[key] for p in parts], axis)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


# -- the layers ----------------------------------------------------------------


def test_halo_conv_matches_unsharded_conv(ranks):
    """A 3×3×3 `Conv3d` on two depth shards with halos: each rank's slabs of
    the unsharded convolution, the input gradient (each halo's cotangent
    sent back to its owner) and the weight and bias gradients, the ranks'
    parts summed."""
    inputs = ranks.inputs
    parts = [o["layers"]["conv"] for o in ranks.two.results()]
    x = inputs["layer_x"].clone().requires_grad_(True)
    conv = tvol.Conv3d(3, 5, 3, padding=1)
    conv.load_state_dict(inputs["layer_conv"])
    y = conv(x)
    y.backward(inputs["layer_g"])
    assert parts[0]["y"].shape == (2, 5, 4, 6, 5)
    _close(_joined(parts, "y"), y.detach())
    _close(_joined(parts, "dx"), x.grad)
    _close(sum(p["dw"] for p in parts), conv.weight.grad)
    _close(sum(p["db"] for p in parts), conv.bias.grad)


def test_sharded_instance_norm_matches_unsharded(ranks):
    parts = [o["layers"]["norm"] for o in ranks.two.results()]
    x = ranks.inputs["norm_x"].clone().requires_grad_(True)
    y = tvol.instance_norm_3d(x)
    y.backward(ranks.inputs["norm_g"])
    _close(_joined(parts, "y"), y.detach())
    _close(_joined(parts, "dx"), x.grad)


# -- the steps -----------------------------------------------------------------


def _results(ranks, mesh):
    return ranks.two.results() if mesh == "1x2" else ranks.four.results()


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_step_losses_and_codebook_match_unsharded(ranks, mesh, against):
    """The first step's global losses and the EMA codebook (sums over all
    ranks, as GSPMD's one global computation has them) against the
    unsharded step's, at `tests/test_volumetric.py`'s tolerances."""
    got = _results(ranks, mesh)[0]["f32"][0]
    want = ranks.jax if against == "jax" else ranks.port
    for name in ("total", "recon", "commit"):
        np.testing.assert_allclose(got["m"][name], want.m[name], rtol=1e-4, err_msg=name)
    embed, cluster_size, embed_avg = got["after"]["vq"]
    np.testing.assert_allclose(cluster_size.numpy(), want.after["vq"][1].numpy(), rtol=1e-4)
    np.testing.assert_allclose(embed.numpy(), want.after["vq"][0].numpy(), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(embed_avg.numpy(), want.after["vq"][2].numpy(), rtol=1e-3,
                               atol=1e-5)
    assert float(cluster_size.sum()) > 0


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("part", ["enc", "dec"])
def test_step_gradients_match_unsharded(ranks, mesh, part):
    """Adam's first moment after the first step ((1 − β1)·g, the summed
    global gradient) against JAX's and the port's unsharded step's, within
    5× the rounding floor."""
    got = _results(ranks, mesh)[0]["f32"][0]["after"][part + "_exp_avg"]
    names = sorted(got)
    cat = lambda sd: torch.cat([sd[k].flatten() for k in names])  # noqa: E731
    g = cat(got)
    port = cat(ranks.port.after[part + "_mu"])
    floor = _rel(cat(ranks.floor.after[part + "_mu"]), port)
    assert _rel(g, cat(ranks.jax.after[part + "_mu"])) <= limit(floor), (part, floor)
    assert _rel(g, port) <= limit(floor), (part, floor)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_ranks_hold_bit_identical_states(ranks, mesh):
    """After each of two steps every rank holds the same parameters, Adam
    moments and steps, gradients, codebook and metrics."""
    outs = _results(ranks, mesh)
    for n in range(2):
        first = outs[0]["f32"][n]
        for other in outs[1:]:
            o = other["f32"][n]
            assert o["m"] == first["m"]
            for key, sd in first["after"].items():
                if key == "vq":
                    assert all(torch.equal(a, b) for a, b in zip(sd, o["after"]["vq"]))
                else:
                    assert all(torch.equal(v, o["after"][key][k]) for k, v in sd.items()), key


def test_mesh_places_ranks_as_jax_reshapes_devices(ranks):
    assert [o["coords"] for o in ranks.four.results()] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_averaged_vq_statistics_would_fail(ranks):
    """The planted fault: the VQ's counts and sums averaged over the ranks
    (`pmean`, the data-parallel trainers' rule) instead of summed. The
    losses do not see it; `cluster_size` is off by the rank count."""
    bad = ranks.four.results()[0]["averaged"][0]
    for name in ("total", "recon", "commit"):
        np.testing.assert_allclose(bad["m"][name], ranks.jax.m[name], rtol=1e-4)
    want = ranks.jax.after["vq"][1].numpy()
    np.testing.assert_allclose(bad["after"]["vq"][1].numpy() * 4, want, rtol=1e-4)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad["after"]["vq"][1].numpy(), want, rtol=1e-4)


def test_bf16_remat_step_matches_unsharded_bf16(ranks):
    """bf16 compute with per-block remat on 1 × 2 against the port's
    unsharded bf16 remat step from the same weights."""
    got = ranks.two.results()[0]["bf16_remat"][0]
    want, f32 = ranks.bf16, ranks.port
    for name in ("total", "recon", "commit"):
        assert abs(got["m"][name] - want.m[name]) <= BF16_LOSS_RTOL * abs(want.m[name]), name
    for a, b in zip(got["after"]["vq"], want.after["vq"]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=BF16_CODEBOOK_RTOL,
                                   atol=BF16_CODEBOOK_RTOL * float(b.abs().max()))
    for part in ("enc", "dec"):
        mu = got["after"][part + "_exp_avg"]
        names = sorted(k for k in mu if k.endswith("weight"))
        cat = lambda sd: torch.cat([sd[k].flatten() for k in names])  # noqa: E731
        own = _rel(cat(want.after[part + "_mu"]), cat(f32.after[part + "_mu"]))
        assert _rel(cat(mu), cat(want.after[part + "_mu"])) <= BF16_GRAD_NOISE * own, part


def test_remat_replays_collectives_in_the_same_order_on_every_rank(ranks):
    """Non-reentrant checkpointing replays each block's halo exchanges and
    norm all-reduces in the backward: both ranks issue the same collectives
    in the same order, and remat issues more than the plain bf16 step."""
    outs = ranks.two.results()
    remat = [o["bf16_remat"][0]["log"] for o in outs]
    plain = [o["bf16"][0]["log"] for o in outs]
    assert remat[0] == remat[1] and plain[0] == plain[1]
    halos = [sum(e[0] == "halo" for e in log) for log in (remat[0], plain[0])]
    reduces = [sum(e[0] == "all_reduce" for e in log) for log in (remat[0], plain[0])]
    assert halos[0] > halos[1] > 0 and reduces[0] > reduces[1] > 0
    assert remat[0][-2][0] == "all_reduce"  # the gradients' sum, then the metrics'


# -- the decode ----------------------------------------------------------------


@pytest.mark.parametrize("out", ["f32", "uint8"])
def test_spatial_decode_matches_jax(ranks, out):
    got = torch.cat([o["decode"][out] for o in ranks.two.results()], 1).numpy()
    want = ranks.jax_decode
    assert got.shape == want.shape == SHAPE[:4]
    if out == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    scaled = (np.clip(want, -1, 1) + 1.0) * 127.5
    clear = (np.abs(scaled - np.rint(scaled)) > 1e-4 * 127.5) | (np.abs(want) >= 1.0)
    levels = np.abs(got.astype(np.int32) - scaled.astype(np.uint8).astype(np.int32))
    assert got.dtype == np.uint8 and clear.mean() > 0.95  # 2.55% of levels lie near one
    assert levels[clear].max() == 0 and levels.max() <= 1


def test_spatial_decode_checks_labels_on_every_rank(ranks):
    msgs = [o["decode"]["bad_label"] for o in ranks.two.results()]
    assert all(m is not None and "outside [-4, 5]" in m for m in msgs), msgs


# -- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("what,match", [
    ("depth", r"depth 12 over spatial=2 ranks is 6 slabs a rank, not divisible by 2\^2 = 4"),
    ("mesh_size", "a data=2 x spatial=2 mesh needs 4 ranks; the process group has 2"),
    ("no_mesh", "2 ranks without a mesh")])
def test_refusals(ranks, what, match):
    msg = ranks.two.results()[0]["refused"][what]
    assert msg is not None and re.search(match, msg), msg


def test_mesh_without_a_group():
    mesh = pmesh.create_volumetric_mesh(1, 1)
    assert (mesh.size, mesh.coords, mesh.world_group) == (1, (0, 0), None)
    with pytest.raises(ValueError, match="needs 2 ranks; the process group has 1"):
        pmesh.create_volumetric_mesh(1, 2)
    x = np.arange(2 * 4).reshape(2, 4)
    assert mesh.block(x) is not None and np.array_equal(mesh.block(x), x)


# -- the CLIs on two ranks -------------------------------------------------------


def test_train_cli_on_two_ranks_matches_unsharded(ranks):
    """`train_volumetric --mesh 1,2` on two ranks: rank 0 alone prints and
    writes one checkpoint and panel, close to the unsharded run's."""
    from PIL import Image

    outs = ranks.two.results()
    assert [o["train_rc"] for o in outs] == [0, 0] and outs[1]["train_stdout"] == ""
    assert "mesh: data=1 x spatial=2" in outs[0]["train_stdout"]
    alone = ranks.train_alone
    mesh_dir = ranks.work / "train_mesh"
    assert sorted(os.listdir(mesh_dir)) == ["recon_mid.png", "volumetric_ckpt"]
    sd, want = (load_state_file(str(d / "volumetric_ckpt")) for d in (mesh_dir, alone))
    for part in ("enc", "dec"):
        assert sd[part].keys() == want[part].keys()
        for k, v in sd[part].items():
            assert float((v - want[part][k]).abs().max()) <= 3 * 2 * LR, (part, k)
    np.testing.assert_allclose(sd["vq"]["cluster_size"].numpy(),
                               want["vq"]["cluster_size"].numpy(), rtol=1e-2)
    # the panel: the unsharded forward of the checkpoint the mesh run wrote,
    # on the first batch (rank 0's centre slices gathered from rank 1)
    from medical_image_editing_tpu_torch.utils.imaging import save_image_grid

    enc, dec = (tvol.VolumetricUNetEncoder(filters=worker.FILTERS),
                tvol.VolumetricUNetDecoder(filters=worker.FILTERS))
    enc.load_state_dict(sd["enc"])
    dec.load_state_dict(sd["dec"])
    vq = VQState(sd["vq"]["embed"], sd["vq"]["cluster_size"], sd["vq"]["embed_avg"].t())
    vol = ttrain._synthetic_volumes(4, 16, 0)[:2]
    with torch.no_grad():
        recon = tvol.volumetric_forward(enc, dec, vq, torch.from_numpy(vol), train=False)[0]
    panel = np.concatenate([vol[:, 8], recon[:, 8].numpy()])
    save_image_grid((panel + 1.0) / 2.0, str(ranks.work / "want.png"), nrow=2)
    a, b, c = (np.asarray(Image.open(p), np.int32) for p in (
        mesh_dir / "recon_mid.png", ranks.work / "want.png", alone / "recon_mid.png"))
    half = a.shape[0] // 2
    assert a.shape == b.shape == c.shape and np.array_equal(a[:half], c[:half])
    assert np.abs(a - b).max() <= 1 and np.abs(a - b).mean() < 1e-2


def test_train_cli_step_lines_match_unsharded(ranks):
    got = _steps(ranks.two.results()[0]["train_stdout"])
    want = ranks.train_alone_steps
    assert len(got) == len(want) == 3
    for n, (g, w) in enumerate(zip(got, want)):
        for k in ("total", "recon", "commit"):
            tol = 2e-4 if n == 0 else 1e-2 * abs(w[k])
            assert abs(g[k] - w[k]) <= tol, (n, k, g, w)


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
def test_edit_cli_partition_spatial_matches_unsharded(ranks, tmp_path, uint8):
    """`edit_volume --partition spatial` on two ranks (rank 0 writes every
    file, the tail batch padded) against the unsharded CLI on the same
    checkpoint."""
    name = "edit_mesh_u8" if uint8 else "edit_mesh"
    assert [o[name] for o in ranks.two.results()] == [0, 0]
    argv = ranks.inputs["edit_argv"] + (["--uint8"] if uint8 else [])
    assert tedit.main(argv + ["--out", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(os.listdir(ranks.work / name)) == [
        f"edited_v{i}.npy" for i in range(3)]
    for f in files:
        got, want = np.load(ranks.work / name / f), np.load(tmp_path / f)
        assert got.dtype == want.dtype and got.shape == (16, 16, 16)
        if uint8:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
