"""ctypes binding of the native host-IO library (`native/medimg_io.cpp`).

The port's own wrapper (the JAX package's `data/native_loader.py` would
import JAX through its package): loads a batch of per-slice `.npy` files
into one float32 (B,H,W) buffer on a C++ thread pool that runs without the
GIL, optionally fusing an elementwise epilogue into each slice's pass (the
HU windowing of `ops/windowing.normalize`, or the [0,255] → [-1,1]
intensity map of CRC/BraTS).

The library is built at first use from the repository's source with `g++`
into `medical_image_editing_tpu_torch/_build/` (git-ignored), keyed by a
hash of the source and flags. `is_available()` says whether it built and
loaded; the loader falls back to numpy when it did not.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "medimg_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

#: epilogue kinds understood by the native library
EP_NONE, EP_WINDOW, EP_INTENSITY = 0, 1, 2

_lib = None
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmedimg_io-{digest[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++, c++ or $CXX) to build the native loader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise OSError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)


def _load_lib():
    """The loaded library, built first if needed; None (and `_error` set)
    when it cannot be built or loaded."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    lib.medimg_load_npy_batch_ep.restype = ctypes.c_int
    lib.medimg_load_npy_batch_ep.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None if it loaded)."""
    _load_lib()
    return _error


def load_npy_batch(
    paths: Sequence[str],
    rows: int,
    cols: int,
    window: Optional[tuple] = None,
    epilogue: Optional[tuple] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Load len(paths) fixed-size 2-D `.npy` slices → (B, rows, cols) float32.

    window: optional (width, center, scale), shorthand for the EP_WINDOW
    epilogue. epilogue: optional (kind, p0, p1, p2), fused into the worker
    threads. n_threads 0 means the host's hardware concurrency."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native medimg_io library unavailable ({_error})")
    if window is not None:
        if epilogue is not None:
            raise ValueError("pass either window or epilogue")
        w, c, s = window
        epilogue = (EP_WINDOW, float(w), float(c), float(s))
    kind, p0, p1, p2 = (list(epilogue or (EP_NONE,)) + [0.0, 0.0, 0.0])[:4]
    encoded = [p.encode() + b"\0" for p in paths]
    blob = b"".join(encoded)
    offsets = np.zeros(len(paths), np.int64)
    if len(paths) > 1:
        offsets[1:] = np.cumsum([len(e) for e in encoded[:-1]])
    out = np.empty((len(paths), rows, cols), np.float32)
    rc = lib.medimg_load_npy_batch_ep(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        int(kind), float(p0), float(p1), float(p2), n_threads,
    )
    if rc != 0:
        err, idx = -(-rc // 1000), (-rc) % 1000
        raise IOError(f"medimg_io error {-err} loading {paths[idx]!r} (code {rc})")
    return out
