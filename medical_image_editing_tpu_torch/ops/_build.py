"""Build and load the package's CUDA sources (`csrc/*.cu`) at first use.

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with `ctypes`. The output goes to
`medical_image_editing_tpu_torch/_build/`, keyed by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is not.
`nvcc`'s `-Xptxas -v` report (registers, shared memory, spills per kernel)
is kept beside each library; `ptxas_report` returns it.

`launches` counts kernel launches by name: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: Counter = Counter()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of medical_image_editing_tpu_torch are built at first use"
    )


def library_path(stem: str) -> Path:
    src = (CSRC_DIR / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(stems: Optional[Iterable[str]] = None) -> None:
    """Compile every listed source (default: all) that is not built yet, one
    `nvcc` process per source, all started together. Raises on failure."""
    stems = list(sources() if stems is None else stems)
    todo = [s for s in stems if not library_path(s).exists()]
    if not todo:
        return
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for stem in todo:
        out = library_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
        procs.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built first if needed."""
    if stem not in _loaded:
        build_all([stem])
        _loaded[stem] = ctypes.CDLL(str(library_path(stem)))
    return _loaded[stem]


def ptxas_report(stem: str) -> str:
    """`nvcc -Xptxas -v` output of the build of `csrc/<stem>.cu`."""
    return library_path(stem).with_suffix(".ptxas.txt").read_text()
