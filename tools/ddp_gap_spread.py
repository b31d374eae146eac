#!/usr/bin/env python3
"""Spread of the f32 gaps that `chip_smoke.py`'s ddp phase holds to limits.

The ddp phase runs two gloo ranks sharing one card and holds their first
step to a serial reference of the same function on all the rows: the first
stage in f32 within `DDP_GAP_LIMIT["float32"]`, the three GAN trainers
within `DDP_GAN_GAP_LIMIT`. This tool measures how far those gaps move
under changes at the rounding level, to set the limits from a spread
rather than from one reading.

For each seed: the two ranks run once as the phase runs them (f32 only;
the healthy run and the run with the planted fault). Then the serial
reference of each trainer is computed as shipped and under each change of
its step at the rounding level:

  xla        the xla conv route (cuDNN's convolutions in place of the
             packed kernel);
  cudnn_off  cuDNN off (PyTorch's native CUDA convolutions);
  ulp        the quantized features nudged by one ulp up or down at
             random (`chip_smoke.ulp_nudged_quantization`);
  cudnn_order  the packed kernel's f32 (`ieee`) instance summing each
             output's taps in cuDNN's order (ky before kx) instead of the
             shipped one (kx before ky): the source edited and built beside the
             shipped one (`tools/sweep_build.py`) and swapped in for the
             reference's step. Not shipped: it only measures the spread.

Every serial reference replays the ranks' VQ ids in its first step, as the
phase's does. Each (seed, trainer, reference) prints one JSON line: both
healthy ranks' first-step gaps to that reference, the planted fault's, and
how many ids the replay held against the reference's own choice; a line
before them holds the cuDNN-order variant to the shipped kernel and to
cuDNN at one training point. The last line sums up: for each limit key,
the largest healthy gap over every seed and reference, 5× it, the planted
fault's smallest gap over that, and, for the keys the fault is checked
against (`DDP_FAULT_KEYS`), how far it lands above 5× the largest gap.

    python3 tools/ddp_gap_spread.py [--seeds 0,1,2]

Needs one CUDA card; run from the repository's root. Lines go to stdout
and to `spread.jsonl` beside the variant's build, in the package's
ignored build directory (`_build/ddp_gap_spread`).
"""

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the ranks import it by this name)
from sweep_build import build_variants, edited  # noqa: E402

WORLD = 2
SIZE, ROWS, STEPS, GAN_STEPS = 256, 4, 3, 2  # the ddp phase's first stage
# the f32 kernel's taps in cuDNN's order: ky outer, kx inner (the outer
# loop's header, then the inner one's)
CUDNN_ORDER = [("for (int kx = 0; kx < 3; ++kx)  //", "for (int ky = 0; ky < 3; ++ky)  //"),
               ("#pragma unroll\n        for (int ky = 0; ky < 3; ++ky) {",
                "#pragma unroll\n        for (int kx = 0; kx < 3; ++kx) {")]


@contextlib.contextmanager
def cudnn_off():
    import torch

    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


@contextlib.contextmanager
def kernel_library(lib):
    """Inside the block the packed conv's wrapper launches from `lib` (a
    build of a variant of its source) instead of the shipped build."""
    from medical_image_editing_tpu_torch.ops import conv_pack

    shipped = conv_pack._kernel_lib()
    lib.conv3x3_packed_launch.argtypes = shipped.conv3x3_packed_launch.argtypes
    lib.conv3x3_packed_launch.restype = shipped.conv3x3_packed_launch.restype
    conv_pack._lib = lib
    try:
        yield
    finally:
        conv_pack._lib = shipped


def cudnn_order_library():
    """The cuDNN-order variant built, and held at 32→32, 256², batch 8 to
    the shipped kernel and to cuDNN under `ieee` → (library, record)."""
    import torch
    import torch.nn.functional as F

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops.conv_pack import conv3x3_packed_nchw

    out = _build.BUILD_DIR / "ddp_gap_spread"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "conv3x3_packed.cu").read_text()
    lib = build_variants({"cudnn_order": edited(src, CUDNN_ORDER, "conv3x3_packed")}, out,
                         "conv3x3_packed")["cudnn_order"][0]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 32, 256, 256, generator=g, device="cuda")
    w = torch.randn(32, 32, 3, 3, generator=g, device="cuda") / 17.0
    shipped = conv3x3_packed_nchw(x, w)
    with kernel_library(lib):
        variant = conv3x3_packed_nchw(x, w)
    cudnn = F.conv2d(x, w, padding=1)
    return lib, {"variant": "cudnn_order",
                 "vs_cudnn_max_abs": float((variant - cudnn).abs().max()),
                 "vs_shipped_max_abs": float((variant - shipped).abs().max()),
                 "shipped_vs_cudnn_max_abs": float((shipped - cudnn).abs().max())}


def references(seed, variant):
    """{name: context manager of the change} for the serial references."""
    return {"shipped": contextlib.nullcontext, "xla": lambda: smoke.conv_route("xla"),
            "cudnn_off": cudnn_off, "ulp": lambda: smoke.ulp_nudged_quantization(seed),
            "cudnn_order": lambda: kernel_library(variant)}


def spread(seeds, emit, variant):
    """The measurement (see the module docstring), each record passed to
    `emit`, `variant` the cuDNN-order build → the summary."""
    import torch

    base = smoke.with_dtype(smoke.ddp_config(), "float32")
    gan_bases = {kind: (smoke.ddp_gan_config(kind), g["rows"], g["size"])
                 for kind, g in smoke.DDP_GAN.items()}
    lines = []
    with smoke.conv_route("packed"), tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            t0 = time.perf_counter()
            gan_args = {kind: (cfg, n, side, GAN_STEPS)
                        for kind, (cfg, n, side) in gan_bases.items()}
            ranks = smoke.ddp_run_ranks(Path(tmp) / f"seed{seed}", base, size=SIZE, rows=ROWS,
                                        steps=STEPS, seed=seed, device="cuda",
                                        dtypes=["float32"], gan_args=gan_args, world=WORLD,
                                        timeout=900)
            ranks_s = time.perf_counter() - t0
            for ref_name, change in references(seed, variant).items():
                t0 = time.perf_counter()
                healthy = [r["float32"][False] for r in ranks]
                faulty = [r["float32"][True] for r in ranks]
                with change():
                    ref = smoke.ddp_reference(base, healthy[0], world=WORLD, size=SIZE,
                                              rows=ROWS, steps=STEPS, seed=seed, device="cuda",
                                              vq_ids=smoke.ranks_vq_ids(healthy))
                lines.append({
                    "seed": seed, "trainer": "first_stage", "reference": ref_name,
                    "ids_moved": ref["ids_moved"],
                    "gaps": [{k: v[0] for k, v in smoke.ddp_gaps(run, ref).items()}
                             for run in healthy],
                    "fault_gaps": [{k: v[0] for k, v in smoke.ddp_gaps(run, ref).items()}
                                   for run in faulty],
                    "ranks_s": ranks_s, "reference_s": time.perf_counter() - t0})
                emit(lines[-1])
                for kind, (cfg, n, side) in gan_bases.items():
                    t0 = time.perf_counter()
                    healthy = [r["gan"][kind][False] for r in ranks]
                    faulty = [r["gan"][kind][True] for r in ranks]
                    with change():
                        ref = smoke.ddp_gan_reference(kind, cfg, healthy[0], world=WORLD,
                                                      size=side, rows=n, seed=seed,
                                                      device="cuda",
                                                      vq_ids=smoke.ranks_vq_ids(healthy))
                    torch.cuda.empty_cache()
                    lines.append({
                        "seed": seed, "trainer": kind, "reference": ref_name,
                        "ids_moved": ref["ids_moved"],
                        "gaps": [smoke.ddp_gan_gaps(kind, run, ref) for run in healthy],
                        "fault_gaps": [smoke.ddp_gan_gaps(kind, run, ref) for run in faulty],
                        "reference_s": time.perf_counter() - t0})
                    emit(lines[-1])
    summary = {}
    for trainer in ("first_stage", *gan_bases):
        recs = [r for r in lines if r["trainer"] == trainer]
        summary[trainer] = {}
        for k in recs[0]["gaps"][0]:
            top = max(g[k] for r in recs for g in r["gaps"])
            fault = min(max(g[k] for g in r["fault_gaps"]) for r in recs)
            summary[trainer][k] = {
                "max_gap": top, "limit_5x": 5 * top, "fault_min_gap": fault,
                "fault_key": k in smoke.DDP_FAULT_KEYS[trainer],
                "fault_over_limit_5x": fault / (5 * top) if top else None}
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0,1,2")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ddp_gap_spread: no CUDA device", file=sys.stderr)
        return 1
    from medical_image_editing_tpu_torch.ops import _build

    out_file = _build.BUILD_DIR / "ddp_gap_spread" / "spread.jsonl"
    out_file.parent.mkdir(parents=True, exist_ok=True)

    def emit(rec):
        print(json.dumps(rec), flush=True)
        with open(out_file, "a") as f:
            f.write(json.dumps(rec) + "\n")

    smoke.device_phase()
    smoke.build_phase(["vq_fused", "conv3x3_packed"])
    emit({"card": smoke.nvidia_smi()})
    variant, held = cudnn_order_library()
    emit(held)
    summary = spread([int(s) for s in args.seeds.split(",")], emit, variant)
    emit({"summary": summary, "card": smoke.nvidia_smi()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
