"""Build source variants of one of the port's CUDA sources, for a sweep on one card.

Shared by `tools/conv_s8_sweep.py` and `tools/conv_f32_sweep.py`. A
variant is the source with some of its text replaced (`edited`); every
variant is compiled by an nvcc of its own with the package's flags, all
started at once, and loaded with ctypes (`build_variants`).
"""

import ctypes
import subprocess
import sys
from pathlib import Path


def edited(src: str, edits, stem: str) -> str:
    """`src` with each (text, replacement) of `edits` applied to every
    occurrence; a text that does not occur in `stem`.cu stops the sweep."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{old!r} not found in {stem}.cu")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict, out: Path, stem: str) -> dict:
    """Compile each {name: source text} into `out`/lib`stem`_name.so, one
    nvcc a variant, all at once, each one's ptxas report beside it →
    {name: (library, its path, the nvcc log)}. Stops when one fails."""
    from medical_image_editing_tpu_torch.ops import _build

    procs = {}
    for name, text in sources.items():
        cu, lib_path = out / f"{stem}_{name}.cu", out / f"lib{stem}_{name}.so"
        cu.write_text(text)
        procs[name] = (lib_path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    libs = {}
    for name, (lib_path, proc) in procs.items():
        (out / f"ptxas_{name}.txt").write_text(logs[name])
        if proc.returncode != 0:
            print(logs[name], file=sys.stderr)
            raise SystemExit(f"{stem}.cu, variant {name}: nvcc failed")
        libs[name] = (ctypes.CDLL(str(lib_path)), lib_path, logs[name])
    return libs
