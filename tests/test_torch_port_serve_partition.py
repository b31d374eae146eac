"""The partitioned services (ROADMAP 15(iii)(b), second half):
`serve_http.EditService(partition="data"|"spatial")` and
`run_recon.make_edit_fn`/`serve` with `config.partition = "spatial"`, on
gloo ranks, held to the JAX package's partitioned services
(`tests/test_end_to_end.py:536-596`, `tests/test_edit_batch.py:272-300`)
and to the port's unpartitioned service.

Sizes of the JAX tests: `LungConfig` at filters (4, 8, 16, 32, 64), 64²
maps (16 rows a rank on 1 × 4: each block divisible by 2^4). Both sides
decode with the same weights: JAX's `load_model` draws them, and the ranks
load them from a Lightning `.ckpt` written with
`utils/weights.py::from_jax_train_state`. The ranks are spawned once for
the module (`tests/torch_serve_partition_worker.py`, torch and the port
only; a `file://` rendezvous in a tmp dir; they wait for the inputs the
test writes), and JAX's side runs in this process meanwhile: two ranks
(the 1 × 2 "spatial" and 2 × 1 "data" services, the HTTP round trip,
`run_recon`'s partitioned edit function and loop, an idle follower under a
group timeout of a few seconds), four (the 1 × 4 "spatial" service), and
two spawns of two ranks with a decode failure planted on rank 0 or rank 1.

Tolerances: f32 decodes after the lung re-window within atol
1e-4·4096/1500 of JAX's (JAX's own partitioned tests hold 1e-4 before it);
the "data" service within 1e-5 of the port's unpartitioned one (the same
per-map decode at another batch size); uint8 within one level; the mask
bit for bit.
"""

import io
import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_partition_worker as worker
from medical_image_editing_tpu.cli import edit_batch as jeb
from medical_image_editing_tpu.cli import run_recon as jrr
from medical_image_editing_tpu.cli import serve_http as jsh
from medical_image_editing_tpu_torch.cli import edit_batch as teb
from medical_image_editing_tpu_torch.cli import run_recon as trr
from medical_image_editing_tpu_torch.cli import serve_http as tsh
from medical_image_editing_tpu_torch.parallel.mesh import VolumetricMesh
from medical_image_editing_tpu_torch.utils import nifti as tnifti
from medical_image_editing_tpu_torch.utils.imaging import PNG_SIGNATURE
from medical_image_editing_tpu_torch.utils.weights import from_jax_train_state

FILTERS, SIZE = worker.FILTERS, worker.SIZE
DICT = 10  # LungConfig's dict_size
LUNG_ATOL = 1e-4 * 4096 / 1500
DATA_ATOL = 1e-5
TIMEOUT = 150  # seconds from a spawn's start to its ranks' exit
FAIL_GROUP_TIMEOUT_S = 20  # the planted-failure spawns' group timeout
FAIL_BOUND_S = 45  # every rank gone within this of the failing request


class Ranks:
    """The `world` rank processes of one task of `torch_serve_partition_worker`,
    with the time each was seen to end."""

    def __init__(self, task, world, workdir, timeout_s=None):
        ctx = torch.multiprocessing.get_context("spawn")
        self.task, self.workdir = task, workdir
        init = str(workdir / f"{task}.init")
        self.procs = [ctx.Process(target=worker.run,
                                  args=(r, world, init, task, str(workdir), timeout_s))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + TIMEOUT
        self.ended = [None] * world
        self._out = None

    def join(self):
        """Wait for every rank (until the deadline), noting when each ended;
        kill what is left → the ranks still alive at the deadline."""
        while time.monotonic() < self.deadline and any(p.is_alive() for p in self.procs):
            for i, p in enumerate(self.procs):
                if self.ended[i] is None and not p.is_alive():
                    self.ended[i] = time.time()
            time.sleep(0.05)
        for i, p in enumerate(self.procs):
            if self.ended[i] is None and not p.is_alive():
                self.ended[i] = time.time()
        hung = [i for i, p in enumerate(self.procs) if p.is_alive()]
        self.kill()
        return hung

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()

    def results(self):
        """Each rank's saved outputs, after all exited 0 within the timeout."""
        if self._out is None:
            hung = self.join()
            assert not hung, f"{self.task}: ranks {hung} still running after {TIMEOUT} s"
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * len(codes), f"{self.task}: exit codes {codes}"
            self._out = [torch.load(os.path.join(self.workdir, f"{self.task}-{r}.pt"),
                                    weights_only=False) for r in range(len(self.procs))]
        return self._out


def _jax_config(partition=None):
    class TinyConfig(jrr.LungConfig):
        enc_filters = FILTERS
        dec_filters = FILTERS

        def __init__(self):
            self.resume_checkpoint = None
            self.edited_file_path = None
            self.save_dir_path = "unused"
            self.compute_dtype = None
            if partition is not None:
                self.partition = partition

    return TinyConfig()


def _maps(seed, shape):
    ids = np.random.default_rng(seed).integers(0, DICT + 1, shape).astype(np.int32)
    ids[..., : SIZE // 8, :] = 0  # a background band
    return ids


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts every spawn, writes the inputs the ranks wait for, then
    computes JAX's side and the port's unpartitioned service while they
    run."""
    work = tmp_path_factory.mktemp("serve_partition")
    spawns = {}
    n = torch.get_num_threads()
    try:
        spawns["two"] = Ranks("two", 2, work)
        spawns["four"] = Ranks("four", 4, work)
        for r in (0, 1):
            spawns[f"fail{r}"] = Ranks(f"fail{r}", 2, work, FAIL_GROUP_TIMEOUT_S)
        torch.set_num_threads(2)
        _, jdec, state = jrr.load_model(_jax_config())
        groups = from_jax_train_state(state)
        ckpt = str(work / "tiny.ckpt")
        torch.save({"state_dict": {f"{g}.{k}": v for g, sd in groups.items()
                                   for k, v in sd.items()}}, ckpt)
        inputs = {"ckpt": ckpt, "one": _maps(1, (SIZE, SIZE)), "three": _maps(2, (3, SIZE, SIZE)),
                  "recon_map": _maps(3, (SIZE, SIZE)), "edited": str(work / "edited.nii.gz"),
                  "ports": {0: _free_port(), 1: _free_port()}}
        tnifti.save(np.transpose(inputs["recon_map"].astype(np.float64)[::-1, ::-1]),
                    inputs["edited"])
        torch.save(inputs, work / "inputs.tmp")
        os.replace(work / "inputs.tmp", work / "inputs.pt")

        want = {}
        build, jsh.build_service = jsh.build_service, lambda config: (jdec, state)
        try:
            with jax.default_matmul_precision("highest"):
                spatial = jsh.EditService(_jax_config(), partition="spatial")
                want["spatial"] = {"one": spatial.edit(inputs["one"])[0],
                                   "three": spatial.edit(inputs["three"])[0],
                                   "one_u8": spatial.edit(inputs["one"], uint8=True)[0]}
                unsharded = jeb.make_batched_edit_fn(jdec, is_lung=True)
                want["unsharded"] = {k: np.asarray(unsharded(state.dec_vars, state.vq,
                                                             jnp.asarray(v)))
                                     for k, v in (("one", inputs["one"][None]),
                                                  ("three", inputs["three"]))}
                data = jsh.EditService(_jax_config(), partition="data")
                want["data"] = {"batch_multiple": data._batch_multiple,
                                "one": data.edit(inputs["one"])[0],
                                "three": data.edit(inputs["three"])[0]}
                jfn = jrr.make_edit_fn(jdec, state, _jax_config("spatial"))
                want["recon_edit_fn"] = jfn(inputs["recon_map"][None])
        finally:
            jsh.build_service = build
        port = tsh.EditService(worker.tiny_config(ckpt), device="cpu")
        want["port_none"] = {"one": port.edit(inputs["one"])[0],
                             "three": port.edit(inputs["three"])[0],
                             "one_u8": port.edit(inputs["one"], uint8=True)[0]}
        port.close()
        torch.set_num_threads(n)
        yield {"spawns": spawns, "inputs": inputs, "want": want, "work": work}
    finally:
        torch.set_num_threads(n)
        for s in spawns.values():
            s.kill()


# -- the "spatial" service -------------------------------------------------


@pytest.mark.parametrize("task,mesh", [("two", (1, 2)), ("four", (1, 4))])
def test_spatial_service_matches_jax(ranks, task, mesh):
    """Rank 0's answers on a 1 × 2 and a 1 × 4 mesh (one map, a batch of
    three padded to four, the uint8 decode) against JAX's
    `EditService(partition="spatial")` and its unsharded decode on the same
    weights; every follower decoded each of rank 0's requests."""
    out = ranks["spawns"][task].results()
    want = ranks["want"]
    r0 = out[0]["spatial"]
    assert r0["mesh"] == mesh and r0["batch_multiple"] == 1
    assert r0["one"].shape == (SIZE, SIZE) and r0["three"].shape == (3, SIZE, SIZE)
    for key in ("one", "three"):
        np.testing.assert_allclose(r0[key], want["spatial"][key], atol=LUNG_ATOL, rtol=0)
        np.testing.assert_allclose(r0[key], want["unsharded"][key].reshape(r0[key].shape),
                                   atol=LUNG_ATOL, rtol=0)
    gap = np.abs(r0["one_u8"].astype(int) - want["spatial"]["one_u8"].astype(int))
    assert r0["one_u8"].dtype == np.uint8 and gap.max() <= 1
    for r in out[1:]:
        assert r["spatial"]["followed"] == {"edit": 3, "stop": 1}


def test_request_is_two_counted_broadcasts(ranks):
    """A request reaches the followers as two broadcasts (the five-int64
    header, then the int32 maps), counted with the decode's collectives."""
    got = ranks["spawns"]["two"].results()[0]["spatial"]["one_collectives"]
    assert got["broadcast"] == 2
    assert got["broadcast_bytes"] == 5 * 8 + SIZE * SIZE * 4


# -- the "data" service ----------------------------------------------------


def test_data_service_pads_like_jax(ranks):
    """On 2 ranks the batch pads to a multiple of 2 (JAX: of its devices) and
    is sliced back: a 1-map and a 3-map request come back with their own
    shapes, equal to the port's unpartitioned service and within the
    tolerance of JAX's partitioned one."""
    out = ranks["spawns"]["two"].results()
    want = ranks["want"]
    r0 = out[0]["data"]
    assert r0["mesh"] == (2, 1) and r0["batch_multiple"] == 2
    assert want["data"]["batch_multiple"] == len(jax.devices())
    for key, shape in (("one", (SIZE, SIZE)), ("three", (3, SIZE, SIZE))):
        assert r0[key].shape == want["data"][key].shape == shape
        np.testing.assert_allclose(r0[key], want["port_none"][key], atol=DATA_ATOL, rtol=0)
        np.testing.assert_allclose(r0[key], want["data"][key], atol=LUNG_ATOL, rtol=0)
    assert np.abs(r0["one_u8"].astype(int) - want["port_none"]["one_u8"].astype(int)).max() <= 1
    assert out[1]["data"]["followed"] == {"edit": 3, "stop": 1}


# -- HTTP, idle followers, failures -----------------------------------------


def test_http_round_trip_with_a_follower(ranks):
    """Rank 0 serves on a local port while rank 1 follows: /healthz reports
    the partition; the .npy and the PNG are JAX's decode; a label past the
    codebook and a map 40 columns wide (not divisible by 2^4) are answered
    400 and never reach rank 1; the next request is answered; rank 1 stops
    when rank 0 closes."""
    from PIL import Image

    out = ranks["spawns"]["two"].results()
    want = ranks["want"]
    http = out[0]["http"]
    assert http["healthz"]["partition"] == "spatial" and http["healthz"]["status"] == "ok"
    code, body = http["npy"]
    assert code == 200
    np.testing.assert_allclose(np.load(io.BytesIO(body)), want["spatial"]["one"],
                               atol=LUNG_ATOL, rtol=0)
    code, body = http["png"]
    assert code == 200 and body[:8] == PNG_SIGNATURE
    png = np.asarray(Image.open(io.BytesIO(body))).astype(int)
    assert np.abs(png - want["spatial"]["one_u8"].astype(int)).max() <= 1
    code, body = http["bad"]
    assert code == 400 and f"[{DICT + 1}] outside".encode() in body
    code, body = http["bad_shape"]
    assert code == 400 and b"2^4" in body
    code, body = http["after_bad"]
    assert code == 200
    np.testing.assert_allclose(np.load(io.BytesIO(body)), want["spatial"]["three"],
                               atol=LUNG_ATOL, rtol=0)
    assert out[1]["http"]["followed"] == {"edit": 3, "stop": 1}  # npy, png, after_bad


def test_data_http_refuses_maps_the_decoder_cannot_take(ranks):
    """On the 2 × 1 "data" service, 3 maps of 40 rows (not divisible by
    2^4, which the decoder's four poolings need on every rank) are answered
    400 before they reach rank 1, and the next request is answered as the
    unpartitioned service answers it; the service goes on serving."""
    out = ranks["spawns"]["two"].results()
    http = out[0]["http_data"]
    code, body = http["bad_shape"]
    assert code == 400 and b"2^4" in body
    code, body = http["after_bad"]
    assert code == 200
    np.testing.assert_allclose(np.load(io.BytesIO(body)), ranks["want"]["port_none"]["three"],
                               atol=DATA_ATOL, rtol=0)
    assert out[1]["http_data"]["followed"] == {"edit": 1, "stop": 1}


def test_idle_follower_outlives_the_group_timeout(ranks):
    """Under a group timeout of IDLE_TIMEOUT_S, rank 0 idles for 2.5 times
    it between two requests: its ticks (a quarter of the timeout apart)
    keep the follower's wait short of the timeout, and the second request
    is decoded as the first."""
    out = ranks["spawns"]["two"].results()
    r0, r1 = out[0]["idle"], out[1]["idle"]
    assert r0["group_timeout_s"] == r1["group_timeout_s"] == worker.IDLE_TIMEOUT_S
    assert r0["tick_s"] == worker.IDLE_TIMEOUT_S / 4
    np.testing.assert_array_equal(r0["after"], r0["before"])
    followed = r1["followed"]
    assert followed["edit"] == 2 and followed["stop"] == 1
    assert followed["tick"] >= worker.IDLE_S / r0["tick_s"] - 2


@pytest.mark.parametrize("failing", [0, 1])
def test_failed_decode_ends_every_rank(ranks, failing):
    """A decode that raises on one rank (rank 0 or its follower) at the
    second request: the client gets 200 then 500, and every rank ends with
    a nonzero exit within FAIL_BOUND_S of that request, none left inside a
    collective."""
    spawn = ranks["spawns"][f"fail{failing}"]
    hung = spawn.join()
    assert not hung, f"ranks {hung} still running"
    codes = [p.exitcode for p in spawn.procs]
    assert all(c not in (0, None) for c in codes), codes
    with open(ranks["work"] / f"fail{failing}-0.json") as f:
        replies = json.load(f)
    assert [code for _, code in replies] == [200, 500]
    assert max(spawn.ended) - replies[1][0] < FAIL_BOUND_S, (spawn.ended, replies)
    err = (ranks["work"] / f"fail{failing}-0.err").read_text()
    assert "RankFailure" in err


# -- run_recon ---------------------------------------------------------------


def test_recon_spatial_edit_fn_matches_jax(ranks):
    """`make_edit_fn` with `config.partition = "spatial"` on 2 ranks against
    JAX's (GSPMD over its devices): the mask bit for bit, the recon within
    the tolerance, on every rank."""
    want_recon, want_mask = ranks["want"]["recon_edit_fn"]
    for r in ranks["spawns"]["two"].results():
        got = r["recon_edit_fn"]
        assert got["recon"].shape == got["mask"].shape == (1, SIZE, SIZE)
        np.testing.assert_array_equal(got["mask"], np.asarray(want_mask))
        np.testing.assert_allclose(got["recon"], np.asarray(want_recon), atol=LUNG_ATOL, rtol=0)


def test_recon_serve_on_two_ranks(ranks):
    """`run_recon.main --partition spatial --max-iters 2` on 2 ranks: rank 0
    prints one Processing and one Skip and writes the two PNGs; rank 1
    reads nothing, writes nothing and ends when rank 0 stops."""
    out = ranks["spawns"]["two"].results()
    r0, r1 = out[0]["recon_serve"], out[1]["recon_serve"]
    assert r0["rc"] == r1["rc"] == 0
    assert r0["stdout"].count("Processing...") == 1 and r0["stdout"].count("Skip...") == 1
    assert len(r0["written"]) == 2
    assert {f.split("/")[-1].split("_")[0] for f in r0["written"]} == {"recon", "label"}
    assert all(f.startswith("inference/") and f.endswith(".png") for f in r0["written"])
    assert r1["written"] == [] and "Processing" not in r1["stdout"]


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("partition", ["data", "spatial"])
def test_partitioned_service_without_a_group_raises(ranks, partition):
    """No process group: the partitioned service raises, never serving
    unpartitioned, and so does its CLI."""
    cfg = worker.tiny_config(ranks["inputs"]["ckpt"])
    with pytest.raises(RuntimeError, match="process group"):
        tsh.EditService(cfg, partition=partition, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tsh.main(["--partition", partition, "--device", "cpu", "--warm", "none"])


def test_recon_spatial_without_a_group_raises(ranks, tmp_path, monkeypatch):
    cfg = worker.tiny_config(ranks["inputs"]["ckpt"], partition="spatial")
    _, dec, vq = trr.load_model(worker.tiny_config(ranks["inputs"]["ckpt"]), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        trr.make_edit_fn(dec, vq, cfg, device="cpu")
    monkeypatch.setenv("LUNG_EDITED_FILE", ranks["inputs"]["edited"])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="process group"):
        trr.main(["--partition", "spatial", "--device", "cpu", "--max-iters", "1"])


def test_mains_parse_partition(monkeypatch):
    """Both CLIs take `--partition` as JAX's do: serve_http none|data|spatial,
    run_recon none|spatial; `run_recon --partition data` is refused by both."""
    got = {}
    monkeypatch.setattr(tsh, "serve", lambda config, **kw: got.update(kw))
    assert tsh.main(["--partition", "none", "--device", "cpu"]) == 0
    assert got["partition"] == "none" and got["mesh"] is None
    for module in (trr, jrr):
        with pytest.raises(SystemExit):
            module.main(["--partition", "data"])
    monkeypatch.setattr(trr, "serve", lambda config, **kw: got.update(recon=config.partition))
    assert trr.main(["--device", "cpu"]) == 0
    assert got["recon"] == "none"


def test_check_request_refuses_rows_that_do_not_split(ranks):
    """Rank 0's host-side check: maps whose rows a rank (H over the spatial
    axis, else H) or whose width is not divisible by 2^levels, or a label
    past the codebook, raise `ValueError` before the request goes out;
    maps the decoder takes on every rank pass."""
    _, dec, _ = trr.load_model(worker.tiny_config(ranks["inputs"]["ckpt"]), device="cpu")
    rows, data = VolumetricMesh(1, 2), VolumetricMesh(2, 1)
    teb.check_request(np.zeros((1, 64, 16), np.int32), DICT, dec, rows, "spatial")
    teb.check_request(np.zeros((3, 48, 32), np.int32), DICT, dec, data, "data")
    for mesh, partition, shape in ((rows, "spatial", (1, 40, 16)),  # 20 rows a rank
                                   (rows, "spatial", (1, 33, 16)),  # rows do not split
                                   (rows, "spatial", (1, 64, 8)),  # width 8
                                   (data, "data", (3, 40, 16)),  # 40 rows
                                   (data, "data", (3, 64, 40))):  # width 40
        with pytest.raises(ValueError, match="2\\^4"):
            teb.check_request(np.zeros(shape, np.int32), DICT, dec, mesh, partition)
    with pytest.raises(ValueError, match="outside"):
        teb.check_request(np.full((1, 64, 16), DICT + 1, np.int32), DICT, dec, rows, "spatial")


def test_group_timeout_is_the_one_the_port_made_the_group_with(tmp_path):
    """`group_timeout` reads the timeout `init_process_group` recorded, and
    raises for a default group made elsewhere or after it is gone, instead
    of guessing."""
    import torch.distributed as dist

    from medical_image_editing_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(RuntimeError, match="unknown"):
        pmesh.group_timeout()
    try:
        pmesh.init_process_group("gloo", f"file://{tmp_path}/a.init", 0, 1, 7.5)
        assert pmesh.group_timeout() == 7.5
        pmesh.destroy_distributed()
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/b.init", rank=0,
                                world_size=1)
        with pytest.raises(RuntimeError, match="unknown"):
            pmesh.group_timeout()
    finally:
        pmesh.destroy_distributed()
    with pytest.raises(RuntimeError, match="unknown"):
        pmesh.group_timeout()
