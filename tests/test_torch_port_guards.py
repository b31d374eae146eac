"""Guards of the PyTorch port: it imports neither JAX, flax, orbax nor the
JAX package, its entry points refuse to fall back to the CPU, `chip_smoke.py`
fails without a card, and its serve, train, serve_runtime, trainer, prior,
second_stage, multi_window, vqgan, losses, volumetric, int8 and
ckpt_crossing phases run end to end at tiny size on the CPU.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = "medical_image_editing_tpu_torch"

TINY_MODEL = {
    "in_channels": 1, "enc_filters": [4, 8, 8, 16, 16],
    "dec_filters": [8, 8, 16, 16, 32], "dict_size": 6,
    "knn_backend": "pallas", "use_pixel_shuffle": False,
    "dropped_skip_layers": [],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the phases' small tensors: several test
    workers on one host, each with a thread per core, spin OpenMP barriers
    against each other (the trainer phase took 383 s beside another
    torch-heavy file, 7 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / PKG).rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "roots = ('jax', 'flax', 'orbax', 'medical_image_editing_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 62
    assert {f"{PKG}.models.vqgan", f"{PKG}.models.actnorm", f"{PKG}.train.vqgan_stage",
            f"{PKG}.ops.perceptual", f"{PKG}.ops.dropblock", f"{PKG}.models.volumetric",
            f"{PKG}.train.volumetric", f"{PKG}.cli.train_volumetric", f"{PKG}.cli.edit_volume",
            f"{PKG}.data.preprocess", f"{PKG}.ops.quantized_conv", f"{PKG}.utils.torch_export",
            f"{PKG}.utils.torch_import", f"{PKG}.cli.import_ckpt",
            f"{PKG}.cli.export_ckpt", f"{PKG}.parallel", f"{PKG}.parallel.mesh",
            f"{PKG}.cli.export_model", f"{PKG}.cli.doctor", f"{PKG}.utils.witness",
            f"{PKG}.utils.labels", f"{PKG}.parallel.spatial", f"{PKG}.cli.edit_batch",
            f"{PKG}.models.blocks", f"{PKG}.models.unet_decoder", f"{PKG}.models.mingpt",
            f"{PKG}.train.prior", f"{PKG}.cli.train_prior"} <= set(modules)


def test_spatial_module_imports_torch_and_the_port_only():
    """`parallel/spatial.py` (the halo exchange standing in for GSPMD)
    imports torch and modules of the port, nothing of the JAX package."""
    import ast

    tree = ast.parse((ROOT / PKG / "parallel" / "spatial.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add("." if node.level else node.module.split(".")[0])
    assert roots == {"typing", "torch", "."}, roots


@pytest.fixture
def tf32_flags():
    """The cuDNN and matmul TF32 flags, restored after the test."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _cli_calls():
    from medical_image_editing_tpu_torch.cli import (
        edit_batch,
        edit_volume,
        run_recon,
        run_vqwnet,
        serve_http,
        train_prior,
        train_volumetric,
    )

    return {
        "run_vqwnet": lambda: run_vqwnet.main(
            ["-c", str(ROOT / "configs" / "lung_first_stage.json"), "-m", "train"]),
        "run_recon": lambda: run_recon.main(["--max-iters", "1"]),
        "serve_http": lambda: serve_http.main(["--warm", "none"]),
        "edit_batch": lambda: edit_batch.main(["--label-dir", ".", "--out-dir", "."]),
        "train_volumetric": lambda: train_volumetric.main(["--steps", "1"]),
        "edit_volume": lambda: edit_volume.main(["--ckpt", ".", "--labels", ".", "--out", "."]),
        "train_prior": lambda: train_prior.main(
            ["-c", str(ROOT / "configs" / "lung_first_stage.json")]),
    }


@pytest.mark.parametrize("value", [None, "tf32", "ieee", "bf16"],
                         ids=["unset", "tf32", "ieee", "unknown"])
@pytest.mark.parametrize("cli", ["run_vqwnet", "run_recon", "serve_http", "edit_batch",
                                 "train_volumetric", "edit_volume", "train_prior"])
def test_cli_applies_conv_precision(cli, value, monkeypatch, tf32_flags):
    """Each CLI sets cuDNN's f32 convolution precision from
    MEDIMG_CONV_PRECISION first (unset: the default, tf32) and keeps
    matmuls at full f32; an unknown value raises before anything runs. On
    a host without a card each call then stops at the device, after the
    flags are set (the flags are set and read without a card)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CLIs would run")
    from medical_image_editing_tpu_torch.utils.device import DEFAULT_CONV_PRECISION

    if value is None:
        monkeypatch.delenv("MEDIMG_CONV_PRECISION", raising=False)
    else:
        monkeypatch.setenv("MEDIMG_CONV_PRECISION", value)
    # the opposite of what the CLI should set, so that a CLI that sets
    # nothing fails
    want = (value or DEFAULT_CONV_PRECISION) == "tf32"
    torch.backends.cudnn.allow_tf32 = not want
    torch.backends.cuda.matmul.allow_tf32 = True
    if value == "bf16":
        with pytest.raises(ValueError, match="MEDIMG_CONV_PRECISION='bf16'"):
            _cli_calls()[cli]()
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cli_calls()[cli]()
    assert torch.backends.cudnn.allow_tf32 == want
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_one_tf32_api():
    """The port, its tests and chip_smoke.py set TF32 through the
    `allow_tf32` flags only: mixed with the `fp32_precision` settings, a
    later read of `allow_tf32` can raise."""
    files = [*(ROOT / PKG).rglob("*.py"), ROOT / "chip_smoke.py",
             *(ROOT / "tests").glob("test_torch_*.py")]
    found = [str(p.relative_to(ROOT)) for p in files
             if p.name != Path(__file__).name
             and re.search(r"\.fp32_precision\b", p.read_text())]
    assert not found, found


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from medical_image_editing_tpu_torch.cli import (
        edit_batch,
        edit_volume,
        export_ckpt,
        export_model,
        import_ckpt,
        run_recon,
        run_vqwnet,
        serve_http,
        train_prior,
        train_volumetric,
    )
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model
    from medical_image_editing_tpu_torch.train.evaluate import (
        make_eval_forward,
        make_vqgan_eval_forward,
    )
    from medical_image_editing_tpu_torch.models.mingpt import GPTConfig
    from medical_image_editing_tpu_torch.train.prior import create_prior_state
    from medical_image_editing_tpu_torch.train.volumetric import init_volumetric

    def lung():
        cfg = LungConfig()
        cfg.resume_checkpoint, cfg.edited_file_path = None, "edited.nii.gz"
        return cfg

    for call in (lambda: load_model(LungConfig()),
                 lambda: make_eval_forward(torch.nn.Identity(), torch.nn.Identity()),
                 lambda: make_batched_edit_fn(torch.nn.Identity()),
                 lambda: serve_http.EditService(lung()),
                 lambda: run_recon.serve(lung(), max_iters=1),
                 lambda: run_recon.main(["--max-iters", "1"]),
                 lambda: serve_http.main(["--warm", "none"]),
                 lambda: edit_batch.main(["--label-dir", ".", "--out-dir", "."]),
                 lambda: run_vqwnet.main(["-c", str(ROOT / "configs" / "lung_first_stage.json"),
                                          "-m", "train"]),
                 lambda: make_vqgan_eval_forward(torch.nn.Identity()),
                 lambda: run_vqwnet.main(["-v", "-c", str(ROOT / "configs" / "crc_vqgan.json"),
                                          "-m", "train"]),
                 lambda: init_volumetric(torch.Generator()),
                 lambda: edit_volume.make_volumetric_edit_fn(torch.nn.Identity()),
                 lambda: train_volumetric.main(["--steps", "1"]),
                 lambda: edit_volume.main(["--ckpt", ".", "--labels", ".", "--out", "."]),
                 lambda: train_volumetric.main(["--steps", "1", "--mesh", "1,1"]),
                 lambda: edit_volume.main(["--ckpt", ".", "--labels", ".", "--out", ".",
                                           "--partition", "spatial"]),
                 lambda: make_batched_edit_fn(torch.nn.Identity(), quantize="int8"),
                 lambda: edit_batch.main(["--label-dir", ".", "--out-dir", ".",
                                          "--dtype", "int8"]),
                 lambda: edit_batch.main(["--label-dir", ".", "--out-dir", ".",
                                          "--partition", "spatial"]),
                 lambda: edit_batch.main(["--label-dir", ".", "--out-dir", ".",
                                          "--partition", "data"]),
                 lambda: import_ckpt.main(["-c", str(ROOT / "configs" / "lung_first_stage.json"),
                                           "--ckpt", "missing.ckpt", "--out", "."]),
                 lambda: export_ckpt.main(["-c", str(ROOT / "configs" / "lung_first_stage.json"),
                                           "--ckpt", "missing", "--out", "out.ckpt"]),
                 lambda: export_model.main(["--out", "edit.pt2", "--allow-random-init"]),
                 lambda: train_prior.main(["-c", str(ROOT / "configs" / "lung_first_stage.json")]),
                 lambda: create_prior_state(0, GPTConfig(vocab_size=11, block_size=16,
                                                         n_layer=1, n_head=2, n_embed=8))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_chip_smoke_fails_without_card(tmp_path):
    # in the checkout, on a host without a CUDA device
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # alone in a directory, without the package
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_clean_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_serve_phase_on_cpu(tmp_path, capsys):
    smoke = _chip_smoke()
    launches, _ = smoke.serve_phase("cpu", TINY_MODEL, tmp_path, size=32, slices=4,
                                 requests=2, seed=0)
    assert launches == {}  # CPU tensors take the plain path: no kernel launch
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "serve" and rec["files_written"] == 4
    assert rec["cpu_reference_id_agreement"] == 1.0
    assert len(rec["edit_request_s"]) == 2 and len(rec["encode_batch_s"]) == 2


def test_chip_smoke_train_phase_on_cpu(capsys):
    smoke = _chip_smoke()
    cfg = smoke.load_config()
    cfg.model.vqmodel.enc_filters = [4, 8, 8, 16, 16]
    cfg.model.vqmodel.dec_filters = [32, 8, 8, 16, 16]
    with smoke.conv_route("packed"):
        launches, trained = smoke.train_phase("cpu", cfg, size=32, batch=2, steps=2)
    assert launches == {}  # CPU tensors take the plain versions
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "train" and rec["compute_dtype"] == "bfloat16"
    assert rec["routed_convs"] == {"encoder": 0, "decoder": 10}
    assert len(rec["step_s"]) == 2 and trained.state.step == 2
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_serve_runtime_phase_on_cpu(tmp_path, capsys):
    """The serve_runtime phase end to end at tiny size on the CPU: three
    routes, the HTTP service and the file-watching loop; no kernel launch."""
    import numpy as np

    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    painted = smoke.paint(rng.integers(1, 7, (4, 32, 32)), rng, TINY_MODEL["dict_size"])
    launches = smoke.serve_runtime_phase("cpu", TINY_MODEL, painted, tmp_path, requests=2)
    assert launches == {}
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]
    parts = [(r["part"], r.get("route")) for r in recs if r.get("phase") == "serve_runtime"]
    assert parts == [("bf16", "f32"), ("bf16", "bf16_cudnn"), ("bf16", "bf16_packed"),
                     ("http", None), ("watch", None)]
    bf16 = {r["route"]: r for r in recs if r.get("part") == "bf16"}
    assert bf16["f32"]["vs_f32"]["max_abs_err"] == 0.0
    assert bf16["bf16_cudnn"]["vs_f32"]["max_abs_err"] > 0
    assert len(bf16["bf16_packed"]["edit_request_s"]) == 2
    http = next(r for r in recs if r.get("part") == "http")
    assert [c["status"] for c in http["requests"]] == [200, 200, 200, 200, 400, 400, 400]
    watch = next(r for r in recs if r.get("part") == "watch")
    assert watch["recon_pngs"] == watch["label_pngs"] == watch["processed"] == 3
    assert watch["elapsed_s"] < 30 and watch["inotify_active"]
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_edit_partition_part_on_cpu(tmp_path, capsys, monkeypatch):
    """The serve runtime's partitioned-decode part end to end at tiny size
    on the CPU (64², batch 4): four spawned gloo ranks take the 2 × 2
    spatial runs, two of them the data and 1 × 2 spatial runs (f32, bf16 on
    the packed route, int8), the zero-halo fault and `edit_batch
    --partition spatial`; each run within its limit from the spread, every
    rank's collectives as derived from the model, each convolution of the
    bf16 and int8 spatial decodes held to the unsharded one on the gathered
    input, the CLI under a one-rank group bit for bit; then on two ranks
    the partitioned services: `serve_http` on 1 × 2 "spatial" (bf16, the
    packed route) and 2 × 1 "data" (f32), each answer within its mode's
    limits, the 3-map request padded and answered with 3, the label past
    the codebook and a map the poolings do not divide 400 and the next
    request 200, the followers ended; and
    `run_recon.serve` on 1 × 2 with one Processing and one Skip, PNGs from
    rank 0 only; no kernel launch, and TF32 left off."""
    import numpy as np

    monkeypatch.setenv("MEDIMG_CONV_PRECISION", "ieee")
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # the ranks import it by name
    rng = np.random.default_rng(0)
    painted = smoke.paint(rng.integers(1, 7, (4, 64, 64)), rng, TINY_MODEL["dict_size"])
    # the lung decoder's first width: at 8 channels the random-init int8
    # decode's code turns are a heavy tail (the sharded decode's mean gap
    # read 7× its own nudged spread there, and under it at 32 and wider)
    model = dict(TINY_MODEL, dec_filters=[32, 32, 64, 64, 128])
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        launches, serve_launches = smoke.edit_partition_part("cpu", model, painted, tmp_path,
                                                             timeout=240)
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert launches == {} and serve_launches == {}
    out = capsys.readouterr().out.splitlines()
    rec = next(json.loads(line) for line in out
               if line.startswith('{"phase": "serve_runtime", "part": "edit_partition"'))
    services = next(json.loads(line) for line in out
                    if line.startswith('{"phase": "serve_runtime", "part": "serve_partition"'))
    assert sorted(services["checks"]) == ["data_2x1_f32", "recon_serve",
                                          "spatial_1x2_bf16_packed"]
    assert all(all(c.values()) for c in services["checks"].values()), services["checks"]
    for name in ("data_2x1_f32", "spatial_1x2_bf16_packed"):
        run = services["runs"][name]
        assert run["statuses"]["bad_label"] == run["statuses"]["bad_shape"] == 400
        assert run["statuses"]["after_bad"] == 200
        assert all(run["gap"][q][k] <= run["limit"][k] for q in run["gap"]
                   for k in ("max_abs_err", "mean_abs_err"))
        assert run["followed"]["stop"] == 1 and 0 <= run["stop_to_return_s"] < 10
        assert run["healthz"]["partition"] == run["partition"]
    assert services["runs"]["data_2x1_f32"]["shapes"]["three"] == [3, 64, 64]
    assert services["runs"]["data_2x1_f32"]["decodes_per_rank"] == 7
    assert services["runs"]["spatial_1x2_bf16_packed"]["decodes_per_rank"] == 6
    recon = services["runs"]["recon_serve"]
    assert len(recon["written"][0]) == 2 and recon["written"][1] == []
    assert sorted(rec["runs"]) == sorted(name for name, *_ in smoke.EDIT_PART_RUNS)
    assert all(all(c.values()) for c in rec["checks"].values()), rec["checks"]
    assert rec["halo_fault_margin"]["max_abs_err"] >= smoke.EDIT_PART_FAULT_MARGIN
    assert rec["cli_gap"]["one_rank"]["max_abs"] == 0.0 and rec["cli_gap"]["spatial"]["files"] == 4
    assert rec["routed_convs_per_decode"] > 0 and rec["convs_per_decode"] == 58
    spatial = rec["runs"]["spatial_1x2_f32"]["collectives"]
    assert spatial["send"] == spatial["recv"] == 52 and spatial["all_reduce"] == 52
    assert rec["runs"]["spatial_1x2_int8"]["collectives"]["all_reduce"] == 52 + 58
    assert rec["runs"]["data_2x1_f32"]["collectives"] == {"all_reduce": 1,
                                                          "all_reduce_bytes": 16}
    # every convolution the kernels run, held on its halo'd row blocks: the
    # packed ones of the 64², 32² and 16² levels over two ranks of rows
    held = rec["conv_checks"]
    assert sorted(held) == ["spatial_1x2_bf16_packed", "spatial_1x2_int8",
                            "spatial_2x2_bf16_packed"]
    assert held["spatial_1x2_int8"]["convs"] == [58, 58]
    assert held["spatial_1x2_int8"]["max_abs"] == 0.0
    for name in ("spatial_1x2_bf16_packed", "spatial_2x2_bf16_packed"):
        assert set(held[name]["convs"]) == {rec["routed_convs_per_decode"]}
        assert held[name]["heights"] == [10, 18, 34] and held[name]["within_ulp"]
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_export_phase_on_cpu(tmp_path, capsys):
    """The export phase end to end at tiny size on the CPU: both variants
    exported, saved and served by a fresh process that imports no model
    module, bit for bit the eager decode at batch 1 and 3, one operator
    node a routed convolution (the decoder's 32-channel level at 32²); no
    kernel launch."""
    import numpy as np

    smoke = _chip_smoke()
    model = {**TINY_MODEL, "dec_filters": [32, 8, 8, 16, 16]}
    rng = np.random.default_rng(0)
    painted = smoke.paint(rng.integers(1, 7, (3, 32, 32)), rng, TINY_MODEL["dict_size"])
    launches = smoke.export_phase("cpu", model, painted, tmp_path, timed=1)
    assert launches == {}
    rec = next(json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"phase": "export"'))
    assert rec["batches"] == [1] and rec["server_imported_models"] == []
    assert "medical_image_editing_tpu_torch.ops.conv_pack" in rec["server_modules"]
    v = rec["variants"]
    assert sorted(v) == ["bf16_packed", "f32_xla"]
    assert v["bf16_packed"]["op_nodes"] == v["bf16_packed"]["routed_convs_per_decode"] == 10
    assert v["f32_xla"]["op_nodes"] == v["f32_xla"]["routed_convs_per_decode"] == 0
    for r in v.values():
        assert all(g["bit_equal"] for g in r["vs_eager"].values())
        assert r["artifact_bytes"] > 0 and len(r["artifact_decode_s"]) == 1


def test_chip_smoke_trainer_phase_on_cpu(tmp_path, capsys):
    """The trainer phase end to end at tiny size on the CPU (5 steps an
    epoch, as on the card): runs A and B, the resume held bit for bit, test,
    export, the painted decode, the planted faulty resume that the check
    catches; no kernel launch."""
    smoke = _chip_smoke()
    overrides = {"model.vqmodel": {"enc_filters": [4, 8, 8, 16, 16],
                                   "dec_filters": [32, 8, 8, 16, 16]},
                 "dataset": {"batch_size": 2}}
    with smoke.conv_route("packed"):
        launches = smoke.trainer_phase("cpu", tmp_path, size=32, patients=2, slices=5,
                                       overrides=overrides, bare_step_s=[0.1])
    assert launches == {}
    rec = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith('{"phase": "trainer"')][-1]
    assert rec["native_loader"] and rec["same_batch_stream"]
    assert rec["counters"] == {"A": [10, 2], "B": [10, 2]}
    assert rec["resume_gap"] == {"encoder": 0.0, "decoder": 0.0, "codebook_rel": 0.0}
    assert rec["planted_fault_param_gap_lr"] > 0
    assert rec["routed_convs"] == {"encoder": 0, "decoder": 10}
    assert len(rec["fit_step_s"]) == 7 and rec["save_bytes"] > 0
    assert rec["result_csv"][0][1:] == ["Entropy_avg", "Entropy_std", "NMSE_avg", "NMSE_std",
                                        "PSNR_avg", "PSNR_std", "SSIM_avg", "SSIM_std"]
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_prior_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The prior phase end to end at tiny size on the CPU (a 16² grid, 256
    tokens, one layer of 2 heads at n_embed 16; the first stage at
    TINY_MODEL's widths, frozen from a checkpoint written by
    `utils/checkpoint.py`, as the trainer phase's on the card): (a) the
    steps, the sampler, the cached decode within its limit; (c) the
    card-vs-CPU comparison (here CPU against CPU: exact); (b)
    `train_prior.main` restoring the checkpoint, its files and step lines;
    no kernel launch, under the packed conv route too; TF32 left off; the
    conv check at the kernel's shapes."""
    from medical_image_editing_tpu_torch.cli import train_prior
    from medical_image_editing_tpu_torch.train.state import create_train_state, make_optimizer
    from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager

    monkeypatch.setenv("MEDIMG_CONV_PRECISION", "ieee")
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its CPU side imports it
    model = {k: TINY_MODEL[k] for k in ("enc_filters", "dec_filters", "dict_size")}
    cfg = json.loads((ROOT / "configs" / "lung_first_stage.json").read_text())
    cfg["model"]["vqmodel"].update(model)
    cfg["dataset"]["image_size"] = [16, 16]
    enc, dec, _ = train_prior.build_first_stage(cfg, device="cpu", seed=5)
    state = create_train_state(enc, dec, make_optimizer(enc.parameters(), 1e-4),
                               make_optimizer(dec.parameters(), 1e-4), device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(state, 0)
    width = {"n_layer": 1, "n_head": 2, "n_embed": 16}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    pending = []
    try:
        with smoke.conv_route("packed"):
            launches = smoke.prior_phase("cpu", tmp_path, tmp_path / "ckpt", size=16,
                                         width=width, overrides={"model.vqmodel": model},
                                         ref_size=4, defer=pending)
            smoke.finish_reference(pending.pop())
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert launches == {} and not pending
    recs = {r["part"]: r for r in (json.loads(line) for line in capsys.readouterr().out
                                   .splitlines() if line.startswith('{"phase": "prior"'))}
    step, cli, ref = recs["step"], recs["cli"], recs["reference"]
    assert step["tokens"] == 256 and len(step["step_s"]) == 3
    assert step["sample_shape"] == [2, 16, 16] and step["sample_range"][1] < 6
    assert step["decode_positions"] == 256 and step["decode_gap"] <= step["decode_limit"]
    assert step["decode_spread"]["float64"] > 0
    assert [s for s, _, _ in cli["step_lines"]] == [1, 2, 3]
    assert cli["sample_ids_shape"] == [2, 16, 16] and cli["sample_ids_dtype"] == "int32"
    assert cli["config"]["block_size"] == 256 and cli["config"]["n_layer"] == 1
    assert ref["loss_rel_err"] == 0.0 and ref["decode_max_abs_err"] == 0.0
    assert ref["grad_rel_err_vs_f64"]["card"]["gpt"] <= ref["grad_limit"]["gpt"]
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"
    # TINY_MODEL's widths route no conv to the kernel: the conv check at two
    # shapes of the kind the lung widths route
    assert recs["conv"]["shapes"] == 0
    smoke.prior_conv_check("cpu", [(2, 32, 32, 16, 16), (2, 32, 64, 4, 4)], 0)
    conv = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert conv["part"] == "conv" and conv["max_abs_err"] == {"2x32x32x16x16": 0.0,
                                                              "2x32x64x4x4": 0.0}


def test_chip_smoke_second_stage_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The second_stage phase end to end at tiny size on the CPU, staged
    from the trainer phase's run-A first stage: (a) the bare steps, the
    discriminator's work, the TF32 step; the card-vs-CPU comparison (here
    CPU against CPU: exact); (b) runs A and B, the resume held, the
    validation maps, test, export, the painted decode, the planted faulty
    resume that the check catches; no kernel launch."""
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its CPU side imports it
    overrides = {"model.vqmodel": {"enc_filters": [4, 8, 8, 16, 16],
                                   "dec_filters": [32, 8, 8, 16, 16]},
                 "dataset": {"batch_size": 2}}
    with smoke.conv_route("packed"):
        smoke.trainer_phase("cpu", tmp_path, size=32, patients=2, slices=5,
                            overrides=overrides, bare_step_s=[0.1])
        launches = smoke.second_stage_phase(
            "cpu", tmp_path, size=32, batch=2, steps=2, ref_size=32,
            overrides={**overrides, "model.dis": {"D_ch": 4, "resolution": 128}})
    assert launches == {}
    recs = {r.get("part"): r for r in (json.loads(line) for line in capsys.readouterr().out
                                       .splitlines() if line.startswith('{"phase": "second_stage"'))}
    step, ref, run = recs["step"], recs["reference"], recs["run"]
    assert step["routed_convs"] == {"encoder": 0, "decoder": 10} and len(step["step_s"]) == 2
    assert 10 < step["dis_step_forward_equivalents"] < 13
    assert set(step["tf32_loss_rel_gap"]) == set(step["losses_first"])
    assert ref["id_mismatches_clear"] == 0 and max(ref["loss_rel_err"].values()) == 0.0
    assert run["counters"] == {"A": [6, 1], "B": [6, 1]} and run["same_batch_stream"]
    assert all(v == 0.0 for part in ("decoder", "discriminator")
               for v in run["resume_gap"][part].values())
    assert run["planted_fault_gap"]["discriminator"]["sn_max"] > 0
    assert len(run["validation_grids"]) == 4 and run["encoder_frozen"]
    assert run["codebook_rel_distance_from_staged"] > 0
    assert run["result_csv"][0][1:] == ["Entropy_avg", "Entropy_std", "NMSE_avg", "NMSE_std",
                                        "PSNR_avg", "PSNR_std", "SSIM_avg", "SSIM_std"]
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_multi_window_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The multi_window phase end to end at tiny size on the CPU, over a
    seeded tree of 2 × 5 slices (5 steps an epoch, as on the card): (a) the
    bare joint steps, the discriminator's operations counted on the meta
    device, the first and second steps; (c) the card-vs-CPU comparison
    (here CPU against CPU: exact); (b) runs A and B, the resume held, the
    validation maps, the HU export, the painted decode, the planted faulty
    resume that the check catches; no kernel launch, and TF32 left off."""
    import numpy as np

    monkeypatch.setenv("MEDIMG_CONV_PRECISION", "ieee")
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its CPU side imports it
    smoke.write_lung_tree(tmp_path / "data", np.random.default_rng(0), patients=2, slices=5,
                          size=32)
    overrides = {"model.vqmodel": {"enc_filters": [4, 8, 8, 16, 16],
                                   "dec_filters": [32, 8, 8, 16, 16]},
                 "dataset": {"batch_size": 2}, "model.dis": {"D_ch": 4, "resolution": 128}}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with smoke.conv_route("packed"):
            launches = smoke.multi_window_phase("cpu", tmp_path, size=32, batch=2, steps=2,
                                                ref_size=32, overrides=overrides)
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert launches == {}
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase": "multi_window"')]
    steps = {r["mode"]: r for r in recs if r["part"] == "step"}
    ref = next(r for r in recs if r["part"] == "reference")
    run = next(r for r in recs if r["part"] == "run")
    assert sorted(steps) == ["first_step", "joint_step", "second_step"]
    joint = steps["joint_step"]
    assert joint["routed_convs"] == {"encoder": 0, "decoder": 10} and len(joint["step_s"]) == 2
    # 6 generator-pass forwards and input gradients, 18 forwards and their
    # backward: ~66 forward-equivalents
    assert 60 < joint["dis_step_forward_equivalents"] < 72
    assert ref["id_mismatches_clear"] == 0 and max(ref["loss_rel_err"].values()) == 0.0
    assert run["counters"] == {"A": [6, 1], "B": [6, 1]} and run["same_batch_stream"]
    assert all(v == 0.0 for part in ("encoder", "decoder", "discriminator", "codebook")
               for v in run["resume_gap"][part].values())
    assert run["planted_fault_gap"]["discriminator"]["sn_max"] > 0
    assert len(run["validation_grids"]) == 4
    assert run["exported"] == {"image_": 10, "recon_": 10, "label_": 10}
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_vqgan_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The vqgan phase end to end at tiny size on the CPU, over a seeded CRC
    tree of 2 × 5 slices of 32² (5 steps an epoch at batch 2, as on the
    card at batch 8): (a) the bare steps, the operations counted on the
    meta device, the painted decode; (c) the card-vs-CPU comparison (here
    CPU against CPU: exact); (b) runs A and B, the resume held, test, the
    0-based label maps, the planted faulty resumes (the codebook's EMA
    buffers dropped; the discriminator's Adam moments dropped) that the
    checks catch; no kernel launch, under the packed conv route too; TF32
    left off."""
    monkeypatch.setenv("MEDIMG_CONV_PRECISION", "ieee")
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its CPU side imports it
    overrides = {"model.vqgan": {"mid_channels": 4, "emb_dim": 8, "dict_size": 6,
                                 "enc_ch_multiplier": [1, 2, 4], "dec_ch_multiplier": [1, 2, 4],
                                 "num_res_blocks": 1, "dec_attn_resolutions": [8],
                                 "resolution": 32},
                 "dataset": {"batch_size": 2}, "model.dis": {"D_ch": 4, "resolution": 128}}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with smoke.conv_route("packed"):
            launches = smoke.vqgan_phase("cpu", tmp_path, size=32, batch=2, steps=2,
                                         ref_size=32, overrides=overrides, slices=5)
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert launches == {}
    recs = {r["part"]: r for r in (json.loads(line) for line in capsys.readouterr().out
                                   .splitlines() if line.startswith('{"phase": "vqgan"'))}
    step, ref, run = recs["step"], recs["reference"], recs["run"]
    assert len(step["step_s"]) == 2 and step["codebook"] == [6, 8]
    assert 10 < step["dis_step_forward_equivalents"] < 13
    assert 2.5 < step["vqgan_flop"] / step["vqgan_forward_flop"] < 3.5
    assert step["painted_out_shape"] == [2, 1, 32, 32] and step["painted_ids_shape"] == [2, 8, 8]
    assert ref["id_mismatches_clear"] == 0 and max(ref["loss_rel_err"].values()) == 0.0
    assert run["counters"] == {"A": [6, 1], "B": [6, 1]} and run["same_batch_stream"]
    assert all(v == 0.0 for part in ("decoder", "discriminator", "codebook")
               for v in run["resume_gap"][part].values())
    limit = smoke.VQGAN_RESUME_GAP_LIMIT["codebook"]["cluster_size"]
    assert run["planted_fault_gap"]["codebook"]["cluster_size"] > limit
    assert any(run["planted_dis_fault_gap"]["discriminator"][k] > v
               for k, v in smoke.VQGAN_RESUME_GAP_LIMIT["discriminator"].items())
    assert run["validation_grids"] == 4 and run["label_maps"] == 10
    assert run["label_shape"] == [8, 8] and run["label_range"][1] < 6
    assert run["result_csv"][0][1:] == ["Entropy_avg", "Entropy_std", "NMSE_avg", "NMSE_std",
                                        "PSNR_avg", "PSNR_std", "SSIM_avg", "SSIM_std"]
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_losses_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The losses phase end to end at tiny size on the CPU, over a seeded
    tree of 2 × 5 slices (5 steps an epoch, as on the card): (a) the bare
    steps with the VGG loss and DropBlock, the VGG's operations counted on
    the meta device, the ieee and tf32 steps; (b) LPIPS; (c) the VQGAN with
    the VGG loss; (d) the card-vs-CPU comparison (here CPU against CPU:
    exact); (e) runs A and B, the resume held bit for bit, the fallback
    flag logged, the schedule's drop_prob, the checkpoint keys; no kernel
    launch, and TF32 left off."""
    import numpy as np

    monkeypatch.delenv("MEDIMG_VGG19_NPZ", raising=False)
    monkeypatch.delenv("MEDIMG_LPIPS_NPZ", raising=False)
    monkeypatch.setenv("MEDIMG_CONV_PRECISION", "ieee")
    smoke = _chip_smoke()
    smoke.write_lung_tree(tmp_path / "data", np.random.default_rng(0), patients=2, slices=5,
                          size=32)
    overrides = {"model.vqmodel": {"enc_filters": [4, 8, 8, 16, 16],
                                   "dec_filters": [32, 8, 8, 16, 16], "block_size": 7},
                 "dataset": {"batch_size": 2}}
    vqgan = {"model.vqgan": {"mid_channels": 4, "emb_dim": 8, "dict_size": 6,
                             "enc_ch_multiplier": [1, 2, 4], "dec_ch_multiplier": [1, 2, 4],
                             "num_res_blocks": 1, "dec_attn_resolutions": [8],
                             "resolution": 32},
             "model.dis": {"D_ch": 4, "resolution": 128}}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with smoke.conv_route("packed"), pytest.warns(UserWarning, match="No pretrained"):
            launches = smoke.losses_phase("cpu", tmp_path, size=32, batch=2, steps=2,
                                          overrides=overrides, vqgan_overrides=vqgan,
                                          vqgan_size=32, ref_size=32, slices=5)
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert launches == {}
    out = capsys.readouterr().out
    recs = {r["part"]: r for r in (json.loads(line) for line in out.splitlines()
                                   if line.startswith('{"phase": "losses"'))}
    step, ref, run = recs["step"], recs["reference"], recs["run"]
    assert step["routed_convs"] == {"encoder": 0, "decoder": 10} and len(step["step_s"]) == 2
    assert step["perceptual_fallback"] and step["losses_first"]["perceptual"] > 0
    assert step["dropblock"] == {"block_size": 7, "drop_prob": 0.5, "levels": [0, 1, 2, 3]}
    # 4 forwards and 2 input gradients (one forward's operations each: the
    # weights are buffers, no weight gradient)
    assert 5.9 < step["vgg_step_forward_equivalents"] < 6.1
    assert set(step["tf32_loss_rel_gap"]) == set(step["losses_first"])
    assert recs["lpips"]["losses_first"]["perceptual"] > 0
    assert recs["vqgan"]["losses_first"]["perceptual"] > 0
    assert ref["id_mismatches_clear"] == 0 and max(ref["loss_rel_err"].values()) == 0.0
    assert run["counters"] == {"A": [10, 2], "B": [10, 2]} and run["same_batch_stream"]
    assert all(v == 0.0 for v in run["resume_gap"].values())
    assert run["perceptual_fallback_logged"] == [1.0] and run["logged_steps"] == 20
    assert run["drop_prob_by_epoch"] == {"0": [run["drop_prob_schedule"]["0"]],
                                         "1": [run["drop_prob_schedule"]["1"]]}
    assert run["checkpoint_keys_as_switches_off"]
    assert run["cli_default_conv_precision"] == {"applied": "tf32", "cudnn_allow_tf32": True,
                                                 "matmul_allow_tf32": False}
    assert "CLI default conv precision" in out
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"


def test_chip_smoke_volumetric_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The volumetric phase end to end at tiny size on the CPU (filters
    4,8,16, `dict_size` 5, 16³, batch 2): (a) the bare steps in f32 and in
    bf16 with remat, the operations counted on the meta device (remat adds
    the recomputed forwards); (b) `train_volumetric.main` and
    `edit_volume.main` in-process (the step lines, the checkpoint, the PNG,
    the painted decode from .npy, .nii.gz and as uint8, the out-of-range
    label refused); (c) the card-vs-CPU comparison (here CPU against CPU:
    exact); (e) the depth-sharded part on four spawned gloo ranks (a 2 × 2
    mesh: 8 slabs a rank), held to the one-process steps within the limits
    from the spread, the ranks bit for bit, the zero-halo fault above the
    decoder gradient's limit, `edit_volume --partition spatial` on two
    ranks, `--mesh 1,1` under a one-rank group bit for bit; no kernel
    launch, and TF32 left off."""
    monkeypatch.setenv("MEDIMG_CONV_PRECISION", "ieee")
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # the ranks import it by name
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        launches = smoke.volumetric_phase("cpu", tmp_path, size=16, batch=2, steps=2,
                                          filters=(4, 8, 16), dict_size=5, ref_size=16,
                                          cli_steps=3, shard_steps=2)
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert launches == {}
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase": "volumetric"')]
    steps = {r["mode"]: r for r in recs if r["part"] == "step"}
    run = next(r for r in recs if r["part"] == "run")
    ref = next(r for r in recs if r["part"] == "reference")
    assert sorted(steps) == ["bf16_remat", "f32"]
    f32, bf16 = steps["f32"], steps["bf16_remat"]
    assert len(f32["step_s"]) == 2 and f32["launches"] == bf16["launches"] == {}
    assert 2.5 < f32["step_flop"] / f32["forward_flop"] < 3.5
    assert bf16["step_flop"] > f32["step_flop"] and bf16["forward_flop"] == f32["forward_flop"]
    assert max(bf16["loss_rel_gap_to_f32"].values()) < 0.05
    assert [ln.split(":")[0] for ln in run["step_lines"]] == ["step 1", "step 2", "step 3"]
    assert run["checkpoint_bytes"] > 0 and run["recon_png_bytes"] > 0
    assert run["out_of_range_label_refused"] and run["nii_vs_npy_max_abs"] == 0.0
    assert run["uint8_vs_f32_max_level"] == 0 and run["codes_in_encoded_volume"] >= 2
    assert len(run["edit_split_s"]) == 8
    assert ref["id_mismatches_clear"] == 0 and max(ref["loss_rel_err"].values()) == 0.0
    assert ref["instance_norm_size"] == 16 and ref["witnesses"] == 1
    assert ref["grad_rel_err_vs_f64"]["card"] == ref["grad_rel_err_vs_f64"]["cpu"]
    shard = next(r for r in recs if r["part"] == "sharded")
    assert shard["mesh"] == [2, 2] and shard["block"] == [1, 8, 16, 16, 1]
    assert shard["coords"] == [[0, 0], [0, 1], [1, 0], [1, 1]] and shard["backend"] == "gloo"
    assert shard["within_limits"] == shard["ranks_bit_identical"] == {"f32": True,
                                                                       "bf16_remat": True}
    assert shard["halo_fault_margin"]["dec_grad"] >= smoke.VOL_SHARD_FAULT_MARGIN
    assert shard["edit_partition_spatial_gap"]["f32"]["max_abs"] <= 1e-4
    one = shard["one_rank_group"]
    assert one["same_state"] and one["same_png"] and one["same_step_lines"]
    assert one["backend"] == "gloo" and len(one["step_lines"]) == 2
    collectives = shard["rank"]["f32"]["collectives_per_step"]
    assert collectives["send"] == collectives["recv"] > 0 and collectives["all_reduce"] > 0


def test_chip_smoke_int8_phase_on_cpu(tmp_path, capsys):
    """The int8 phase end to end at tiny size on the CPU: the plain
    versions at every convolution of the decode, the decode and its
    microbatched form, the error against f32 framed as JAX's contract, and
    `edit_batch.main --dtype int8`; no kernel launch."""
    import numpy as np

    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    painted = smoke.paint(rng.integers(1, 7, (2, 32, 32)), rng, TINY_MODEL["dict_size"])
    launches, out = smoke.int8_phase("cpu", TINY_MODEL, painted, tmp_path, microbatch=2,
                                     big_batch=4, kernel_batch=2)
    assert launches == {} and out["yardsticks"] is None
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
            if line.startswith('{"phase": "int8"')]
    kernels = [r for r in recs if r["part"] == "kernel"]
    assert all(all(r["checks"].values()) for r in kernels)
    # the ASPP's dilations and 1×1 stage, the 1×1 head to one channel and
    # the 5·f0-channel concat (f0 = 8 here) are among the shapes
    shapes = {(r["cin"], r["cout"], r["kernel"], r["dilation"]) for r in kernels}
    assert {(8, 8, 3, 18), (8, 8, 1, 1), (8, 1, 1, 1), (40, 8, 3, 1)} <= shapes
    decode = next(r for r in recs if r["part"] == "decode")
    assert decode["kernel_equals_plain_on_card"] == {"batch": True, "microbatch": True}
    assert sum(r["calls_per_decode"] for r in kernels) == decode["convs_per_decode"]
    assert decode["vs_f32"]["max_abs_err"] > 0 and decode["jax_contract"]["int8_mean"] > 0
    cli = next(r for r in recs if r["part"] == "cli")
    assert cli["files"] == 2 and cli["equals_make_batched_edit_fn"]


def test_chip_smoke_ckpt_crossing_phase_on_cpu(tmp_path, capsys):
    """The ckpt_crossing phase at tiny widths on the CPU: 2 steps of
    `run_vqwnet`, `export_ckpt`, `import_ckpt`, and `load_model` at both
    directories decoding bit for bit what the trained state decodes."""
    smoke = _chip_smoke()
    overrides = {"model.vqmodel": {"enc_filters": [4, 8, 8, 16, 16],
                                   "dec_filters": [8, 8, 16, 16, 32]},
                 "dataset": {"batch_size": 2}}
    launches = smoke.ckpt_crossing_phase("cpu", tmp_path, size=32, slices=2,
                                         overrides=overrides)
    assert launches == {}
    rec = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith('{"phase": "ckpt_crossing"')][-1]
    assert rec["steps"] == 2 and rec["imported_tensors_equal_run"] and rec["counters_kept"]
    assert rec["decode_equals_trained_state"] == {"imported": True, "run": True}


def test_chip_smoke_ddp_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The ddp phase at tiny widths on the CPU: two spawned gloo ranks (the
    Trainer's replicated state, the gathered k-means, 3 steps) bit for bit
    equal after each step, in bf16 and f32 within the card's limits of one
    process on the same rows after the first step, the planted fault above
    them; the
    one-rank group made by `run_vqwnet` from a torchrun environment bit
    for bit the run without one; then the GAN trainers (second stage,
    joint step, VQGAN) on the same ranks, bit for bit equal, within the
    card's limits of the serial reference, the planted fault (rank 1's
    discriminator gradients unaveraged) above them, the collectives a step
    as derived, and each through `run_vqwnet` under a one-rank group; no
    kernel launch. The one-rank `run_vqwnet` runs start before the ranks
    are joined (they share the card with them), the timed bare steps after
    it."""
    smoke = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # the ranks import it by name
    overrides = {"model.vqmodel": {"enc_filters": [4, 8, 8, 16, 16],
                                   "dec_filters": [32, 8, 8, 16, 16]},
                 "dataset": {"batch_size": 2}}
    # the card's limits, but for the f32 encoder: at these widths (a 2×2
    # bottleneck) its gradient is ill-conditioned, 0.22 from one process
    # here against the card's 0.037 at full widths (the planted fault: 1.18)
    limits = {"bfloat16": smoke.DDP_GAP_LIMIT["bfloat16"],
              "float32": {**smoke.DDP_GAP_LIMIT["float32"], "encoder_moments": 0.5}}
    small = {"model.vqmodel": overrides["model.vqmodel"],
             "model.dis": {"D_ch": 4, "resolution": 128}}
    gan_overrides = {"second_stage": small, "joint": small, "vqgan": {
        "model.vqgan": {"mid_channels": 4, "emb_dim": 8, "dict_size": 6,
                        "enc_ch_multiplier": [1, 2, 4], "dec_ch_multiplier": [1, 2, 4],
                        "num_res_blocks": 1, "dec_attn_resolutions": [8], "resolution": 32},
        "model.dis": {"D_ch": 4, "resolution": 128}}}
    with smoke.conv_route("packed"):
        launches = smoke.ddp_phase("cpu", tmp_path, size=32, rows=2, steps=3,
                                   overrides=overrides, timed_steps=2, limits=limits,
                                   gan={k: {"rows": 2, "size": 32} for k in gan_overrides},
                                   gan_overrides=gan_overrides, gan_steps=2, gan_timed_steps=1)
    assert launches == {}
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase": "ddp"')]
    rec = next(r for r in recs if r["part"] == "two_ranks_one_card")
    gan = {r["trainer"]: r for r in recs if r["part"] == "gan_two_ranks_one_card"}
    assert sorted(gan) == ["joint", "second_stage", "vqgan"]
    for kind, c in gan.items():
        assert c["ranks_bit_identical_each_step"] == [True, True] and c["generator_replicated"]
        assert c["buffer_drift_per_rank"] == [[0, 0], [0, 0]]
        limit = c["gap_limit"]
        assert all(g[k] <= limit[k] for g in c["gap_to_serial"] for k in limit)
        assert c["planted_fault_gap"][1]["discriminator_moments"] > limit["discriminator_moments"]
        assert c["planted_fault_gap"][0] == c["gap_to_serial"][0]  # rank 0 kept the average
        # 8 SPADE BatchNorms a decode, forward and backward; the VQ statistics
        # a training encode; each optimizer's gradients; the buffers; metrics
        assert c["collectives_per_step"][0]["all_reduce"] == {
            "second_stage": 2 * 8 + 4, "joint": 2 * 2 * 8 + 2 + 2 + 3, "vqgan": 1 + 4}[kind]
        assert c["collectives_as_expected"]
    one = next(r for r in recs if r["part"] == "gan_one_rank_group")["trainers"]
    assert all(len(r["logged_total"]) == 2 and r["bare_step"]["group"]["backend"] == "gloo"
               for r in one.values())
    assert sorted(rec["by_dtype"]) == ["bfloat16", "float32"]
    for c in rec["by_dtype"].values():
        assert c["ranks_bit_identical_each_step"] == [True] * 3 and c["generator_replicated"]
        assert c["planted_fault_ranks_bit_identical"] == [False] * 3
        limit = c["gap_limit"]
        assert all(g[k][0] <= limit[k] for g in c["gap_to_one_process"] for k in limit)
        assert c["planted_fault_gap"][1]["decoder_moments"][0] > limit["decoder_moments"]
    assert rec["cli_bit_identical"] == {"log_csv": True, "state": True}
    n_bn = 2 * 4  # two SPADE BatchNorms a decoder level
    assert rec["collectives_per_step"]["all_reduce"] == 2 * 2 * n_bn + 2 + 2 + 1
    group = rec["bare_step"]["group"]
    assert group["backend"] == "gloo" and group["axis_name"] == "data"
    assert group["collectives_per_step"]["all_reduce"] == 2 * 2 * n_bn + 2 + 2 + 1
    assert rec["bare_step"]["alone"]["collectives_per_step"] == {}
    overlap = next(r for r in recs if r["part"] == "gan_one_rank_group")["overlap"]
    assert rec["ranks_share_card_with"] == "one_rank_parts"
    assert all(c["ranks_share_card_with"] == "one_rank_parts" for c in gan.values())
    assert rec["overlap"].items() <= overlap.items()
    assert 0 <= overlap["one_rank_started_s"] < overlap["one_rank_ended_s"]
    assert overlap["one_rank_started_s"] < overlap["ranks_joined_s"] == rec["ranks_seconds"]
    assert overlap["ranks_joined_s"] <= overlap["bare_steps_s"][0]
    assert overlap["bare_steps_s"][1] <= overlap["gan_bare_steps_s"][0]
    assert os.environ.get("WORLD_SIZE") is None


def test_chip_smoke_f32_step_phase_on_cpu(capsys):
    """The f32 readout at tiny widths on the CPU: four forks of one state
    through {ieee, tf32} × {packed, xla}, no kernel launch (CPU tensors take
    the f32 plain version under either precision, so packed and xla agree
    closely in both), the flags restored."""
    import torch

    smoke = _chip_smoke()
    cfg = smoke.load_config()
    cfg.model.vqmodel.enc_filters = [4, 8, 8, 16, 16]
    cfg.model.vqmodel.dec_filters = [32, 8, 8, 16, 16]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    launches = smoke.f32_step_phase("cpu", cfg, size=32, batch=2, steps=1)
    assert set(launches) == {"ieee_packed", "ieee_xla", "tf32_packed", "tf32_xla"}
    assert not any(launches.values())
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "f32_step" and rec["routed_convs"] == {"encoder": 0, "decoder": 10}
    for gaps in rec["loss_gap_packed_minus_xla"].values():
        assert max(abs(v) for v in gaps.values()) < 1e-3
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    assert os.environ.get("MEDIMG_CONV_IMPL") != "packed"
