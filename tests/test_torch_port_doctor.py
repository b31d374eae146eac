"""The port's `doctor` (`cli/doctor.py`), as `tests/test_doctor.py` holds the
JAX package's: every check bounded, the exit code 1 when one fails, and
on this host (no card, no `nvcc`) the backend, nvcc and kernels checks
report FAIL rather than pass."""

import pytest
import torch

from medical_image_editing_tpu_torch.cli import doctor
from medical_image_editing_tpu_torch.ops import _build

CHECKS = ("versions", "env", "backend", "nvcc", "kernels", "native", "mesh")


def _passing(monkeypatch, names=("backend", "nvcc", "kernels", "mesh")):
    """The checks of `names` (by default every one that needs a card, nvcc
    or a subprocess) monkeypatched to pass."""
    for name in names:
        monkeypatch.setattr(doctor, f"check_{name}",
                            lambda *a, _n=name, **k: doctor._line("ok", _n, "stubbed"))


def test_doctor_all_green_with_checks_stubbed(capsys, monkeypatch):
    _passing(monkeypatch)
    rc = doctor.main([])
    out = capsys.readouterr().out
    assert rc == 0
    for name in CHECKS:
        assert f"] {name}" in out
    assert "all checks passed" in out


def test_doctor_skip_backend(capsys, monkeypatch):
    _passing(monkeypatch)
    monkeypatch.setattr(doctor, "check_backend", lambda t: pytest.fail("backend probed"))
    assert doctor.main(["--skip-backend"]) == 0
    assert "] backend" not in capsys.readouterr().out


def test_doctor_backend_probe_failure_sets_exit_code(capsys, monkeypatch):
    """A probe that does not answer in time is a FAIL line and exit 1."""
    import subprocess

    _passing(monkeypatch, names=("nvcc", "kernels", "mesh"))

    def hung(code, timeout_s):
        raise subprocess.TimeoutExpired("python", timeout_s)

    monkeypatch.setattr(doctor, "_run_python", hung)
    rc = doctor.main(["--probe-timeout", "1"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] backend" in out and "did not answer in 1 s" in out


def test_doctor_backend_needs_compute_capability_9(capsys, monkeypatch):
    """A card that is not Hopper is a FAIL: the kernels are sm_90a only."""
    import json
    import subprocess

    probe = {"available": True, "name": "NVIDIA A100-SXM4-80GB", "capability": [8, 0],
             "memory_bytes": 80 * 2**30, "count": 1, "nvidia_smi": "A100, 400.00 W"}
    monkeypatch.setattr(doctor, "_run_python", lambda code, t: subprocess.CompletedProcess(
        [], 0, "probe:" + json.dumps(probe), ""))
    assert not doctor.check_backend(10)
    assert "[FAIL] backend" in capsys.readouterr().out
    probe.update(name="NVIDIA H100 80GB HBM3", capability=[9, 0])
    assert doctor.check_backend(10)
    assert "[ ok ] backend    NVIDIA H100 80GB HBM3, compute capability 9.0" in (
        capsys.readouterr().out)


def test_doctor_on_this_host_names_what_is_missing(capsys, monkeypatch):
    """Here, with no card and no nvcc: the backend, nvcc and kernels checks
    FAIL (never a silent pass) and the doctor exits 1; the mesh check's two
    gloo ranks run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    try:
        _build.nvcc()
        pytest.skip("this host has nvcc")
    except _build.KernelError:
        pass
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    rc = doctor.main([])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] backend    no CUDA card" in out
    assert "[FAIL] nvcc       nvcc not found" in out
    assert "[FAIL] kernels" in out and "not built" in out
    assert "[ ok ] mesh       two-rank gloo all_reduce on the CPU verified" in out
    assert "[ ok ] versions" in out and "FAILURES above" in out


def test_spill_count_of_a_ptxas_report():
    report = ("ptxas info    : Compiling entry function 'k1' for 'sm_90a'\n"
              "ptxas info    : Function properties for k1\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
              "ptxas info    : Function properties for k2\n"
              "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n")
    assert doctor._spills(report) == 12
