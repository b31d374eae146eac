"""The partitioned 2-D edit decode (ROADMAP 15(iii)(b), first half): the
port's `make_batched_edit_fn(mesh=, partition="data"|"spatial")`,
`edit_study(mesh=)` and `edit_batch --partition` on gloo ranks, held to the
JAX package's unsharded decode (as `tests/test_edit_batch.py` holds its
GSPMD and `shard_map` decodes to it) and to the port's own unpartitioned
decode.

Sizes of the JAX tests: filters (4, 8, 16, 32, 64), `dict_size` 6, the
decoder with its pixel-shuffle up-sampling and ASPP head, 32² maps (64²
for the 1 × 4 mesh). Both sides decode with the same flax-initialised
weights (`utils/weights.py::from_jax_decoder`) and the same numpy id maps
from seeds. The ranks are spawned once for the module
(`tests/torch_edit_partition_worker.py`, torch and the port only; a
`file://` rendezvous in a tmp dir; each spawn joined within `TIMEOUT`
seconds): two ranks (1 × 2 spatial in f32, uint8 and int8, the planted
zero halos, a bad label; 2 × 1 data, its refusals, `edit_study` with a
padded tail; the CLI under both partitions) and four (2 × 2 spatial at
32², 1 × 4 at 64² plain and on the packed route). JAX and the port's
unpartitioned runs go in this process while they run.

Tolerances: f32 decodes atol 1e-4 (JAX's own for its partitioned decodes),
×4096/1500 under the lung re-window; uint8 within one level; int8 on 1 × 2
by its mean gap to JAX's unsharded int8 decode (GSPMD's scales are the
whole array's), at most INT8_MEAN_FACTOR × the port's own unsharded int8
decode's (measured 0.0402 against 0.0375), and convolution by convolution
bit for bit the unsharded int8 convolution; the packed route on the CPU
runs the kernel's plain version, at the f32 tolerance. Collectives a
decode (counts and bytes) equal what `chip_smoke.py::edit_part_expected`
derives from the model's layers, as on the card.
"""

import contextlib
import importlib.util
import io
import os
import re
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_edit_partition_worker as worker
from medical_image_editing_tpu.cli import edit_batch as jeb
from medical_image_editing_tpu.models import UNetDecoder as JUNetDecoder
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoderWithVQ
from medical_image_editing_tpu_torch.cli import edit_batch as teb
from medical_image_editing_tpu_torch.cli import run_recon as trr
from medical_image_editing_tpu_torch.models import blocks
from medical_image_editing_tpu_torch.models.unet_decoder import UNetDecoder
from medical_image_editing_tpu_torch.ops.vq import VQState
from medical_image_editing_tpu_torch.parallel.mesh import VolumetricMesh
from medical_image_editing_tpu_torch.parallel.spatial import hop_rows
from medical_image_editing_tpu_torch.utils import nifti as tnifti
from medical_image_editing_tpu_torch.utils.weights import from_jax_decoder

ROOT = Path(__file__).resolve().parents[1]
FILTERS, K = worker.FILTERS, worker.K
ATOL = 1e-4
LUNG_ATOL = ATOL * 4096 / 1500
INT8_MEAN_FACTOR = 2.0
TIMEOUT = 150  # seconds from a spawn's start to its ranks' exit
DECODER = dict(in_channels=FILTERS[0], out_channels=1, filters=FILTERS,
               dropped_skip_layers=(), use_pixel_shuffle=True)


class Ranks:
    """The `world` rank processes of one task of `torch_edit_partition_worker`."""

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


def _jax_models():
    enc = JEncoderWithVQ(filters=FILTERS, dict_size=K)
    dec = JUNetDecoder(out_channels=1, filters=FILTERS, dropped_skip_layers=())
    x0 = jnp.zeros((1, 32, 32, 1), jnp.float32)
    enc_vars, vq = jax.jit(lambda x: enc.init(jax.random.key(0), x))(x0)
    q, *_ = enc(enc_vars, vq, x0, train=False)
    dec_vars = jax.jit(lambda q: dec.init({"params": jax.random.key(1),
                                           "dropblock": jax.random.key(2)}, q,
                                          train=False))(q)
    return dec, dec_vars, vq


def _maps(seed, shape, k):
    ids = np.random.default_rng(seed).integers(0, k + 1, shape).astype(np.int32)
    ids[:, : shape[1] // 8] = 0  # a background band
    return ids


def _write_maps(directory, maps):
    directory.mkdir()
    for i, m in enumerate(maps):
        tnifti.save(np.transpose(m.astype(np.float64)[::-1, ::-1]),
                    str(directory / f"label_{i:03d}.nii.gz"))


@contextlib.contextmanager
def _tiny_lung_config():
    """LungConfig at the test widths, as the worker's CLI runs it."""
    saved = {k: getattr(trr.LungConfig, k) for k in ("enc_filters", "dec_filters")}
    ckpt = os.environ.pop("LUNG_CKPT", None)
    trr.LungConfig.enc_filters = trr.LungConfig.dec_filters = FILTERS
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(trr.LungConfig, k, v)
        if ckpt is not None:
            os.environ["LUNG_CKPT"] = ckpt


def _int8_convs():
    """A 3×3 convolution with bias and the ASPP's 18-row dilated one, seeded."""
    out = []
    gen = torch.Generator().manual_seed(7)
    for kw in (dict(in_channels=5, out_channels=7, kernel_size=3, padding=1),
               dict(in_channels=5, out_channels=6, kernel_size=3, padding=18, dilation=18,
                    bias=False)):
        conv = blocks.Conv(**kw)
        with torch.no_grad():
            for prm in conv.parameters():
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.3)
        out.append((kw, conv.state_dict()))
    return out


def _port_decoder(weights):
    dec = UNetDecoder(**DECODER)
    dec.load_state_dict(weights, strict=True)
    return dec


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts both spawns, then computes the JAX side and the port's
    unpartitioned runs while they run."""
    work = tmp_path_factory.mktemp("edit_partition")
    jdec, dec_vars, vq = _jax_models()
    weights = from_jax_decoder(dec_vars)
    _write_maps(work / "labels", _maps(5, (3, 32, 32), K))
    _write_maps(work / "cli_labels", _maps(6, (3, 32, 32), worker.CLI_DICT))
    inputs = {"decoder": DECODER, "weights": weights,
              "vq": [torch.from_numpy(np.array(a)) for a in vq],
              "ids32": _maps(1, (4, 32, 32), K), "ids64": _maps(2, (1, 64, 64), K),
              "convs": _int8_convs(),
              "conv_x": torch.from_numpy(
                  np.random.default_rng(4).standard_normal((2, 5, 32, 32)).astype(np.float32)),
              "label_dir": str(work / "labels"), "cli_labels": str(work / "cli_labels")}
    torch.save(inputs, work / "inputs.pt")
    started = []
    n = torch.get_num_threads()
    try:
        started.append(Ranks("two", 2, work))
        started.append(Ranks("four", 4, work))
        torch.set_num_threads(2)

        def jax_decode(ids, **kw):
            with jax.default_matmul_precision("highest"):
                return np.asarray(jeb.make_batched_edit_fn(jdec, **kw)(
                    dec_vars, vq, jnp.asarray(ids)))

        lung = dict(is_lung=True)
        want = {"lung32": jax_decode(inputs["ids32"], **lung),
                "uint8_32": jax_decode(inputs["ids32"], output_dtype="uint8", **lung),
                "raw32": jax_decode(inputs["ids32"]),
                "int8_32": jax_decode(inputs["ids32"][:2], quantize="int8", **lung),
                "lung64": jax_decode(inputs["ids64"], **lung)}
        tvq = VQState(*inputs["vq"])
        teb.edit_study(_port_decoder(weights), tvq, inputs["label_dir"],
                       str(work / "study_alone"), batch_size=2, is_lung=True, device="cpu")
        with _tiny_lung_config(), contextlib.redirect_stdout(io.StringIO()):
            for name in ("spatial", "data"):
                assert teb.main(["--label-dir", inputs["cli_labels"], "--batch-size", "2",
                                 "--device", "cpu", "--out-dir",
                                 str(work / f"cli_alone_{name}")]) == 0
    except BaseException:
        for r in started:
            r.kill()
        raise
    finally:
        torch.set_num_threads(n)
    return SimpleNamespace(work=work, inputs=inputs, two=started[0], four=started[1],
                           want=want, weights=weights, tvq=tvq)


def _joined(parts, key, mesh, name):
    """The global decode from the ranks' blocks of `parts[r][name][key]`."""
    d, s = mesh
    blocks_ = [p[name][key] for p in parts]
    return torch.cat([torch.cat(blocks_[i * s:(i + 1) * s], 1) for i in range(d)], 0).numpy()


# -- the decodes against JAX ----------------------------------------------------


CASES = {  # name: (spawn, mesh, task key, JAX reference, rows of the reference)
    "1x2-f32": ("two", (1, 2), ("spatial", "f32"), "lung32", slice(0, 2)),
    "1x2-uint8": ("two", (1, 2), ("spatial", "uint8"), "uint8_32", slice(0, 2)),
    "2x2-f32": ("four", (2, 2), ("spatial22",), "lung32", slice(None)),
    "1x4-f32-64": ("four", (1, 4), ("spatial14",), "lung64", slice(None)),
    "1x4-packed-64": ("four", (1, 4), ("packed14",), "lung64", slice(None)),
    "2x1-data": ("two", (2, 1), ("data",), "raw32", slice(None)),
}


def _case(ranks, case):
    spawn, mesh, keys, ref, sel = CASES[case]
    parts = getattr(ranks, spawn).results()
    for key in keys[:-1]:
        parts = [p[key] for p in parts]
    return _joined(parts, "out", mesh, keys[-1]), ranks.want[ref][sel]


@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_decode_matches_jax(ranks, case):
    """Each partition's gathered decode against JAX's unsharded decode of
    the same maps: the 1 × 4 mesh at 64² takes the ASPP's 18-row halo from
    two ranks (16 rows each); the packed route runs the kernel's plain
    version on halo'd row blocks and keeps the block's rows."""
    got, want = _case(ranks, case)
    assert got.shape == want.shape
    if got.dtype == np.uint8:
        assert want.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        atol = ATOL if case.endswith("data") else LUNG_ATOL
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_int8_spatial_decode_follows_jax(ranks):
    """The gathered 1 × 2 int8 decode against JAX's unsharded int8 decode of
    the same maps (its activation scales the whole array's, as GSPMD's are
    on the mesh), by the mean gap: at most INT8_MEAN_FACTOR × the port's
    own unsharded int8 decode's mean gap to JAX on those maps. The largest
    gap is not held: a rounding-level difference (the port against JAX, or
    the sharded instance norms' sums against the unsharded ones) turns an
    int8 code at a near-tie, and the instance norms carry it on."""
    want = ranks.want["int8_32"]
    alone = teb.make_batched_edit_fn(_port_decoder(ranks.weights), quantize="int8",
                                     is_lung=True, device="cpu")(
        ranks.tvq, ranks.inputs["ids32"][:2]).numpy()
    got = torch.cat([p["spatial"]["int8"]["out"] for p in ranks.two.results()], 1).numpy()
    assert got.shape == want.shape == alone.shape
    own = np.abs(alone - want).mean()
    assert np.abs(got - want).mean() <= INT8_MEAN_FACTOR * own, (np.abs(got - want).mean(), own)


def test_int8_spatial_decode_runs_the_unsharded_int8_convs(ranks):
    """int8 on 1 × 2: every convolution of the decode (62: each its own
    MAX all-reduce of the maxima, `test_collectives_a_decode_match_the_
    derivation`), on the sharded decode's own activations gathered, gives
    bit for bit the unsharded int8 convolution of those activations (JAX's
    global scales; `tests/test_torch_port_quantized_conv.py` holds that one
    to JAX's `int8_conv_call`); the decode as a whole is held to JAX's in
    `test_int8_spatial_decode_follows_jax`."""
    from medical_image_editing_tpu_torch.ops.quantized_conv import quantize_convs

    parts = ranks.two.results()
    dec = _port_decoder(ranks.weights)
    convs = [m for m in dec.modules() if isinstance(m, blocks.Conv)]
    calls = list(zip(*(p["int8_calls"] for p in parts)))
    order = []
    hooks = [m.register_forward_pre_hook(lambda m, a: order.append(m)) for m in convs]
    with torch.no_grad():
        dec(torch.zeros(1, FILTERS[0], 32, 32))
    for h in hooks:
        h.remove()
    assert len(calls) == len(order) == 62
    for module, blocks_ in zip(order, calls):
        x = torch.cat([b[0] for b in blocks_], 2)
        with quantize_convs("int8"), torch.no_grad():
            want = module(x)
        assert torch.equal(torch.cat([b[1] for b in blocks_], 2), want)
    got = torch.cat([p["spatial"]["int8"]["out"] for p in parts], 1).numpy()
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0


@pytest.mark.parametrize("conv", [0, 1], ids=["3x3", "dilated18"])
def test_int8_sharded_conv_is_the_unsharded_conv(ranks, conv):
    """A row-sharded int8 convolution (halo, row padding 0, maxima over the
    ranks) gives each rank the rows of the unsharded int8 convolution: the
    same codes, so the same sums, bit for bit."""
    from medical_image_editing_tpu_torch.ops.quantized_conv import quantize_convs

    kw, sd = ranks.inputs["convs"][conv]
    module = blocks.Conv(**kw)
    module.load_state_dict(sd)
    with quantize_convs("int8"), torch.no_grad():
        want = module(ranks.inputs["conv_x"])
    got = torch.cat([p["int8_convs"][conv] for p in ranks.two.results()], 2)
    assert torch.equal(got, want)


def test_zero_halo_fault_fails_the_comparison(ranks):
    """The planted fault (every halo exchange returning zeros) lands far
    outside the tolerance the real decode holds."""
    parts = ranks.two.results()
    bad = torch.cat([p["fault"] for p in parts], 1).numpy()
    gap = np.abs(bad - ranks.want["lung32"][:2]).max()
    assert gap > 100 * LUNG_ATOL, gap


# -- what the ranks issued ------------------------------------------------------


def _smoke():
    """`chip_smoke.py`, whose derivation of a decode's collectives from the
    model's layers (`decoder_layers`, `edit_part_expected`) the card's
    partitioned decode is held to as well."""
    if "smoke" not in _SMOKE:
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        _SMOKE["smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_SMOKE["smoke"])
    return _SMOKE["smoke"]


_SMOKE = {}


def _layers(shape):
    """Each convolution of an unsharded forward of the test decoder on
    `shape` (NCHW): (kernel rows, row reach, input shape), and the
    instance norms' input shapes, in call order."""
    return _smoke().decoder_layers(UNetDecoder(**DECODER), shape)


def _expected_collectives(mesh, coords, batch, size, int8=False):
    """Collectives and bytes one rank issues for one f32 (or int8) decode of
    `batch` global maps of `size`² on a `mesh` (data, spatial) at `coords`,
    derived from the test decoder's layers."""
    return _smoke().edit_part_expected(UNetDecoder(**DECODER), FILTERS[0], mesh, coords, batch,
                                       size, "int8" if int8 else "f32")


COLLECTIVE_CASES = {  # name: (spawn, task keys, mesh, batch, size, int8)
    "1x2-f32": ("two", ("spatial", "f32"), (1, 2), 2, 32, False),
    "1x2-int8": ("two", ("spatial", "int8"), (1, 2), 2, 32, True),
    "2x2-f32": ("four", ("spatial22",), (2, 2), 4, 32, False),
    "1x4-f32-64": ("four", ("spatial14",), (1, 4), 1, 64, False),
    "2x1-data": ("two", ("data",), (2, 1), 4, 32, False),
}


@pytest.mark.parametrize("case", list(COLLECTIVE_CASES))
def test_collectives_a_decode_match_the_derivation(ranks, case):
    spawn, keys, mesh, batch, size, int8 = COLLECTIVE_CASES[case]
    for r, part in enumerate(getattr(ranks, spawn).results()):
        for key in keys:
            part = part[key]
        coords = (r // mesh[1], r % mesh[1])
        assert part["collectives"] == _expected_collectives(mesh, coords, batch, size, int8), r


def test_ranks_issue_the_same_collectives_in_order(ranks):
    """Every rank of a row logs the same halo exchanges and all-reduces in
    the same order (edge ranks log their exchanges too)."""
    for parts, key in ((ranks.two.results(), ("spatial", "f32")),
                       (ranks.four.results(), ("spatial14",))):
        logs = []
        for p in parts:
            for k in key:
                p = p[k]
            logs.append(p["log"])
        assert all(log == logs[0] for log in logs[1:])
        assert sum(e[0] == "halo" for e in logs[0]) == sum(
            k > 1 for k, *_ in _layers((1, FILTERS[0], 32, 32))[0])


def test_packed_route_launches_as_the_unsharded_decode(ranks):
    """On the packed route each rank calls the packed convolution on the
    convolutions the unsharded decode of the whole map routes (the gate
    reads the global height), each on its block's rows plus a halo row at
    each end."""
    dec = _port_decoder(ranks.weights)
    with worker.counted_packed() as calls, torch.no_grad():
        want = dec(torch.zeros(1, FILTERS[0], 64, 64))
    assert want.shape == (1, 1, 64, 64) and calls["packed"] > 0
    for p in ranks.four.results():
        assert p["packed14"]["calls"] == {"packed": calls["packed"],
                                          "rows": calls["rows"] // 4 + 2 * calls["packed"]}


def test_decoder_is_unsharded_after_a_partitioned_decode(ranks):
    """The edit function shards the caller's decoder for its call only: a
    plain forward after a partitioned decode leaves no mesh on any layer
    and issues no collective."""
    for p in ranks.two.results():
        assert p["after_partitioned"] == {"meshes_left": [], "collectives": {},
                                          "shape": (1, 1, 32, 32)}


def test_labels_out_of_range_raise_on_every_rank(ranks):
    msgs = [p["bad_label"] for p in ranks.two.results()]
    assert all(m is not None and f"outside [{1 - K}, {K}]" in m for m in msgs), msgs


# -- refusals --------------------------------------------------------------------


@pytest.mark.parametrize("what,match", [
    ("odd_batch", "a batch of 3 does not split over 2 ranks"),
    ("data_on_rows", r"partition='data' splits the batch over a data x 1 mesh; this mesh "
                     r"is data=1 x spatial=2")])
def test_rank_refusals(ranks, what, match):
    msg = ranks.two.results()[0]["refused"][what]
    assert msg is not None and re.search(match, msg), msg


def _edit(mesh, partition="spatial", **kw):
    dec = UNetDecoder(**DECODER)
    return teb.make_batched_edit_fn(dec, mesh=mesh, partition=partition, device="cpu", **kw)


def _vq():
    return VQState(torch.randn(K, FILTERS[0]), torch.ones(K), torch.randn(K, FILTERS[0]))


def test_rows_a_rank_must_divide_by_the_pooling_levels():
    """32² over 8 ranks (JAX's `test_spatial_partition_matches_unsharded`
    mesh) is 4 rows a rank: the decoder's 4 max-pools need 16. The check
    is made before any collective, so a mesh without a group shows it."""
    dec = UNetDecoder(**DECODER)
    edit = teb.make_batched_edit_fn(dec, mesh=VolumetricMesh(1, 8), partition="spatial",
                                    device="cpu")
    ids = _maps(3, (2, 32, 32), K)[:, :4]
    with pytest.raises(ValueError, match=re.escape(
            "32 rows over spatial=8 ranks is 4 rows a rank, not divisible by 2^4 = 16")):
        edit(_vq(), ids)
    assert not [n for n, m in dec.named_modules() if getattr(m, "mesh", None)]


@pytest.mark.parametrize("partition,mesh,match", [
    ("spatial", (2, 1), "partition='spatial' needs a 'spatial' mesh axis of more than one"),
    ("rows", (1, 2), "unknown partition 'rows'")])
def test_partition_needs_its_axis(partition, mesh, match):
    """As JAX's `test_spatial_partition_requires_spatial_axis`: a data-only
    mesh has no rows to split."""
    with pytest.raises(ValueError, match=match):
        _edit(VolumetricMesh(*mesh), partition)


def test_one_rank_mesh_is_the_unpartitioned_decode(ranks):
    ids = ranks.inputs["ids32"][:2]
    dec = _port_decoder(ranks.weights)
    alone = teb.make_batched_edit_fn(dec, is_lung=True, device="cpu")(ranks.tvq, ids)
    one = teb.make_batched_edit_fn(dec, is_lung=True, mesh=VolumetricMesh(1, 1),
                                   partition="spatial", device="cpu")(ranks.tvq, ids)
    assert dec.mesh is None and torch.equal(alone, one)


def test_hop_rows():
    assert hop_rows(256, 1) == [1]
    assert hop_rows(16, 18) == [16, 2]
    assert hop_rows(16, 16) == [16]
    assert hop_rows(4, 18) == [4, 4, 4, 4, 2]


# -- edit_study and the CLI --------------------------------------------------------


def _files_close(got_dir, want_dir, atol):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 3
    for f in names:
        got, want = tnifti.load(str(got_dir / f)), tnifti.load(str(want_dir / f))
        assert got.shape == want.shape == (32, 32)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_edit_study_pads_the_tail_under_data(ranks):
    """Three maps in batches of two on a 2 × 1 mesh: the tail batch padded
    with its last map, one map a rank; rank 0 writes every file, as the
    unpartitioned `edit_study` does."""
    ranks.two.results()
    _files_close(ranks.work / "study_data", ranks.work / "study_alone", LUNG_ATOL)


@pytest.mark.parametrize("partition", ["spatial", "data"])
def test_cli_partition_on_two_ranks_matches_unpartitioned(ranks, partition):
    outs = ranks.two.results()
    assert [o["cli_" + partition]["rc"] for o in outs] == [0, 0]
    assert "3 edited volumes" in outs[0]["cli_" + partition]["stdout"]
    assert outs[1]["cli_" + partition]["stdout"] == ""
    _files_close(ranks.work / f"cli_{partition}", ranks.work / f"cli_alone_{partition}",
                 LUNG_ATOL)
