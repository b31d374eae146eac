"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU, `chip_smoke.py` fails
without a card, and its serve phase runs end to end at tiny size on the CPU.
"""

import importlib.util
import json
import os
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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'medical_image_editing_tpu' or m.startswith('medical_image_editing_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 20


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model
    from medical_image_editing_tpu_torch.train.evaluate import make_eval_forward

    for call in (lambda: load_model(LungConfig()),
                 lambda: make_eval_forward(torch.nn.Identity(), torch.nn.Identity()),
                 lambda: make_batched_edit_fn(torch.nn.Identity())):
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


def test_chip_smoke_serve_phase_on_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches, _ = smoke.serve_phase("cpu", TINY_MODEL, tmp_path, size=32, slices=4,
                                 requests=2, seed=0)
    assert launches == {}  # CPU tensors take the plain path: no kernel launch
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "serve" and rec["files_written"] == 4
    assert rec["cpu_reference_id_agreement"] == 1.0
    assert len(rec["edit_request_s"]) == 2 and len(rec["encode_batch_s"]) == 2
