"""`doctor`: bounded environment diagnostics of the port on a CUDA host.

Counterpart of `medical_image_editing_tpu/cli/doctor.py`. A GPU host fails
in ways that surface late or far away: a CUDA stack that hangs the first
call, a card older than the kernels' `sm_90a`, a missing `nvcc` (the
kernels are built at first use), a kernel source that no longer compiles,
a missing g++ that drops the native loader to numpy. Each check here is
bounded in time and prints one `[ ok ]`, `[WARN]` or `[FAIL]` line; the
exit code is 1 if anything failed. A missing card or `nvcc` is a FAIL.

Checks (the JAX check each replaces in brackets):
  versions  python / torch (with its CUDA) / numpy            [versions]
  env       MEDIMG_* / CUDA_VISIBLE_DEVICES / CUDA_HOME        [env]
  backend   CUDA probe in a subprocess with a timeout: the
            card's name, compute capability (the kernels need
            9.0), memory, power limit from nvidia-smi         [backend]
  nvcc      path and version of the CUDA compiler              (new)
  kernels   the `csrc/*.cu` sources built into `_build/` (built
            in a bounded subprocess where missing) and loaded;
            their ptxas spills; the size of `_build/`          [cache]
  native    the C++ host loader builds and loads; host cores   [native]
  mesh      a two-rank gloo all_reduce on the CPU in a bounded
            subprocess; with a card, a one-rank NCCL group too [mesh]

JAX's XLA compile cache, TPU plugin probe and virtual CPU mesh have no
counterpart here (ROADMAP §A, "No port needed").

    python -m medical_image_editing_tpu_torch.cli.doctor [--skip-backend]
        [--probe-timeout 120]
"""

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[2]  # the directory holding the package
BUILD_TIMEOUT_S = 900.0  # nvcc of all three sources, started together
MESH_TIMEOUT_S = 300.0


def _line(status: str, name: str, detail: str = "") -> bool:
    print(f"[{status:^4}] {name:<10} {detail}", flush=True)
    return status != "FAIL"


def _run_python(code: str, timeout_s: float):
    """`python -c code` from the package's root → CompletedProcess; raises
    `subprocess.TimeoutExpired` past `timeout_s`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(PKG_ROOT), env.get("PYTHONPATH"))
                                        if p)
    return subprocess.run([sys.executable, "-c", code], cwd=PKG_ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout_s)


def check_versions() -> bool:
    import platform

    import torch

    parts = [f"python {platform.python_version()}",
             f"torch {torch.__version__} (CUDA {torch.version.cuda or 'none'})"]
    try:
        import numpy

        parts.append(f"numpy {numpy.__version__}")
    except Exception:
        return _line("FAIL", "versions", "cannot import numpy")
    return _line("ok", "versions", ", ".join(parts))


def check_env() -> bool:
    notes = [f"{var}={os.environ[var]}" for var in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME")
             if os.environ.get(var) is not None]
    notes += [f"{var}={os.environ[var]}" for var in sorted(os.environ)
              if var.startswith("MEDIMG_")]
    return _line("ok", "env", "; ".join(notes) or "no overrides")


_PROBE = """
import json, subprocess, torch
out = {"available": torch.cuda.is_available()}
if out["available"]:
    p = torch.cuda.get_device_properties(0)
    out.update(name=p.name, capability=[p.major, p.minor], memory_bytes=p.total_memory,
               count=torch.cuda.device_count())
    torch.ones(1, device="cuda").add_(1).item()  # a launch and a sync
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        out["nvidia_smi"] = None
print("probe:" + json.dumps(out))
"""


def check_backend(timeout_s: float) -> bool:
    """The card, probed in a subprocess so that a hung CUDA stack cannot
    hang the doctor."""
    try:
        r = _run_python(_PROBE, timeout_s)
    except subprocess.TimeoutExpired:
        return _line("FAIL", "backend", f"the CUDA probe did not answer in {timeout_s:.0f} s "
                     "(a hung CUDA stack: anything touching the card would hang)")
    found = [line for line in r.stdout.splitlines() if line.startswith("probe:")]
    if r.returncode != 0 or not found:
        return _line("FAIL", "backend", f"the CUDA probe failed: {r.stderr.strip()[-300:]}")
    probe = json.loads(found[-1][len("probe:"):])
    if not probe["available"]:
        return _line("FAIL", "backend", "no CUDA card (torch.cuda.is_available() is False): "
                     "the port's entry points run on the card unless asked for the CPU")
    cap = tuple(probe["capability"])
    detail = (f"{probe['name']}, compute capability {cap[0]}.{cap[1]}, "
              f"{probe['memory_bytes'] / 2**30:.1f} GiB, {probe['count']} card(s); "
              f"nvidia-smi: {probe['nvidia_smi'] or 'not found'}")
    if cap != (9, 0):
        return _line("FAIL", "backend", f"{detail}: the kernels are built for sm_90a "
                     "(Hopper) and need compute capability 9.0")
    if probe["nvidia_smi"] is None:
        return _line("WARN", "backend", detail)
    return _line("ok", "backend", detail)


def check_nvcc() -> bool:
    from ..ops import _build

    try:
        exe = _build.nvcc()
    except _build.KernelError as e:
        return _line("FAIL", "nvcc", str(e))
    try:
        r = subprocess.run([exe, "--version"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return _line("FAIL", "nvcc", f"{exe} --version: {e}")
    release = re.search(r"release [^\n]*", r.stdout)
    if r.returncode != 0 or not release:
        return _line("FAIL", "nvcc", f"{exe} --version exited {r.returncode}")
    return _line("ok", "nvcc", f"{exe} ({release.group(0)})")


_BUILD = """
import ctypes
from medical_image_editing_tpu_torch.ops import _build
_build.build_all()
for stem in _build.sources():
    ctypes.CDLL(str(_build.library_path(stem)))
print("built")
"""


def _spills(report: str) -> int:
    """Bytes of spill stores over every kernel of a ptxas report."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", report))


def check_kernels(timeout_s: float = BUILD_TIMEOUT_S) -> bool:
    """Every CUDA source built (in a bounded subprocess where missing) and
    loaded; their ptxas spills."""
    from ..ops import _build

    stems = _build.sources()
    missing = [s for s in stems if not _build.library_path(s).exists()]
    try:
        _build.nvcc()
    except _build.KernelError as e:
        if missing:
            return _line("FAIL", "kernels", f"{', '.join(missing)} not built, and {e}")
    try:
        r = _run_python(_BUILD, timeout_s)
    except subprocess.TimeoutExpired:
        return _line("FAIL", "kernels", f"building {', '.join(missing)} took past "
                     f"{timeout_s:.0f} s")
    if r.returncode != 0 or "built" not in r.stdout:
        return _line("FAIL", "kernels", f"build or load failed: {r.stderr.strip()[-500:]}")
    spills = {s: _spills(_build.ptxas_report(s)) for s in stems}
    size = sum(p.stat().st_size for p in _build.BUILD_DIR.rglob("*") if p.is_file())
    built = "built now: " + ", ".join(missing) if missing else "all built before"
    return _line("ok", "kernels",
                 f"{len(stems)} sources loaded ({built}); spill stores "
                 + ", ".join(f"{s} {n} B" for s, n in spills.items())
                 + f"; {_build.BUILD_DIR}: {size / 1e6:.1f} MB")


def check_native() -> bool:
    from ..data import native_loader

    cores = os.cpu_count() or 1
    if not native_loader.is_available():
        return _line("WARN", "native", "C++ loader unavailable "
                     f"({native_loader.unavailable_reason()}): host loading falls back "
                     "to numpy")
    note = f"C++ loader loaded; {cores} host core(s)"
    if cores == 1:
        note += " (single-core host: the loader's thread pool cannot parallelize)"
    return _line("ok", "native", note)


def _mesh_rank(rank, init_file):
    """One rank of the gloo probe: all_reduce of rank + 1 over two ranks."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=2)
    try:
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t)
        if t.item() != 3.0:
            raise RuntimeError(f"gloo all_reduce gave {t.item()}, not 3")
    finally:
        dist.destroy_process_group()


def mesh_probe() -> None:
    """The mesh check's body, run in its own process: two gloo ranks on the
    CPU, then, with a card, a one-rank NCCL group's all_reduce."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_mesh_rank, args=(os.path.join(tmp, "gloo"),), nprocs=2)
        print("gloo-ok", flush=True)
        if torch.cuda.is_available():
            dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl')}",
                                    rank=0, world_size=1)
            try:
                t = torch.full((4,), 2.0, device="cuda")
                dist.all_reduce(t)
                if t.tolist() != [2.0] * 4:
                    raise RuntimeError(f"one-rank NCCL all_reduce gave {t.tolist()}")
            finally:
                dist.destroy_process_group()
            print("nccl-ok", flush=True)


def check_mesh(timeout_s: float = MESH_TIMEOUT_S) -> bool:
    code = "from medical_image_editing_tpu_torch.cli import doctor\ndoctor.mesh_probe()\n"
    try:
        r = _run_python(code, timeout_s)
    except subprocess.TimeoutExpired:
        return _line("FAIL", "mesh", f"the process-group probe timed out ({timeout_s:.0f} s)")
    if r.returncode != 0 or "gloo-ok" not in r.stdout:
        return _line("FAIL", "mesh", f"the process-group probe failed: "
                     f"{r.stderr.strip()[-300:]}")
    note = "two-rank gloo all_reduce on the CPU verified"
    if "nccl-ok" in r.stdout:
        note += "; one-rank NCCL all_reduce on the card verified"
    return _line("ok", "mesh", note)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Environment diagnostics of the port")
    parser.add_argument("--skip-backend", action="store_true",
                        help="skip the CUDA probe (slow when the CUDA stack hangs)")
    parser.add_argument("--probe-timeout", type=float, default=120.0)
    args = parser.parse_args(argv)

    ok = True
    ok &= check_versions()
    ok &= check_env()
    if not args.skip_backend:
        ok &= check_backend(args.probe_timeout)
    ok &= check_nvcc()
    ok &= check_kernels()
    ok &= check_native()
    ok &= check_mesh()
    print("doctor:", "all checks passed" if ok else "FAILURES above")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
