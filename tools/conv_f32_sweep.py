#!/usr/bin/env python3
"""Sweep source variants of the packed 3×3 conv's two f32 kernels on one CUDA card.

Builds `medical_image_editing_tpu_torch/csrc/conv3x3_packed.cu` once for
each variant of SOURCE_VARIANTS (a change of the f32 kernels' code to
weigh: the shipped source, and the source with one of its measured choices
undone: launch bounds, the unrolling of the channel loop, when the
half-height tile is taken) and runs each at the
forward and input-gradient shapes of `chip_smoke.py`'s CONV_POINTS, batch
8, in both f32 modes (0: `conv3x3_f32_kernel`, true f32; 2:
`conv3x3_tf32_kernel`, TF32): its output held bit for bit to the shipped
build's (none of the variants changes an output's order of summation),
then timed with CUDA events, the variants in turns and again in reverse
order. Prints one JSON line a shape and mode, and the static SASS
instruction mix of each f32 kernel of each variant (`cuobjdump -sass`:
FFMA, HMMA, shared-memory loads, cp.async, local-memory spills, barriers).

    python3 tools/conv_f32_sweep.py [--iters 30] [--variants shipped,...] [--out DIR]

The sources, libraries and ptxas reports go to DIR (default: the package's
ignored build directory, `_build/conv_f32_sweep`).

Needs a CUDA card and nvcc; imports neither JAX nor the JAX package.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

from sweep_build import build_variants, edited

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name: [(text, replacement), ...] applied to the source (each text must
# occur); besides the shipped source, each undoes one measured choice
SOURCE_VARIANTS = {
    "shipped": [],
    # the CUDA-core kernel at two blocks an SM (128 registers, spills) for R = 2
    # and three for R = 1
    "f32_minb2": [("__launch_bounds__(kThreads, R == 2 ? 1 : 2)",
                   "__launch_bounds__(kThreads, R == 2 ? 2 : 3)")],
    # one staged channel a turn of its loop
    "f32_ci_unroll1": [("#pragma unroll 2\n    for (int ci = 0; ci < kFCh; ++ci) {",
                        "#pragma unroll 1\n    for (int ci = 0; ci < kFCh; ++ci) {")],
    # its half-height tile only where the tall one gives fewer blocks than SMs
    "f32_short_below_sms": [("tall_blocks < 2LL * sms;", "tall_blocks < sms;")],
    # the TF32 kernel at one block an SM (255 registers)
    "tf32_minb1": [("__launch_bounds__(kThreads, MT * NT == 16 ? 2 : 3)",
                    "__launch_bounds__(kThreads, MT * NT == 16 ? 1 : 2)")],
}
OPS = ("FFMA", "HMMA", "LDS", "LDGSTS", "LDL", "STL", "BAR", "STG", "STS")


def sass_mix(lib_path: Path) -> dict:
    """Static opcode counts of each f32 kernel in the library's SASS."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    mix, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if name and m and ("f32_kernel" in name or "tf32_kernel" in name):
            op = m[1].split(".")[0]
            mix.setdefault(name, Counter())[op if op in OPS else "other"] += 1
    return {re.sub(r".*?(t?f32_kernel)I(\w+)E.*", r"\1<\2>", k): dict(v) for k, v in mix.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--variants", default=",".join(SOURCE_VARIANTS),
                        help="the source variants to build, comma-separated")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    import chip_smoke
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops.conv_pack import MODES, flip_transpose

    if not torch.cuda.is_available():
        print("conv_f32_sweep: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out) if args.out else _build.BUILD_DIR / "conv_f32_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "conv3x3_packed.cu").read_text()
    names = args.variants.split(",")
    built = build_variants({name: edited(src, SOURCE_VARIANTS[name], "conv3x3_packed")
                            for name in names}, out, "conv3x3")
    libs = {}
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (lib, lib_path, log) in built.items():
        lib.conv3x3_packed_launch.argtypes = [vp] * 3 + [i] * 6 + [ll] * 8 + [vp]
        lib.conv3x3_packed_launch.restype = i
        libs[name] = lib
        print(json.dumps({"variant": name, "sass": sass_mix(lib_path),
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "Used" in ln or "spill" in ln]}), flush=True)

    device, batch = torch.device("cuda"), 8
    gen = torch.Generator(device=device).manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    for cin, cout, h in chip_smoke.CONV_POINTS:
        x = torch.randn(batch, cin, h, h, generator=gen, device=device)
        wt = (torch.rand(cout, cin, 3, 3, generator=gen, device=device) * 2 - 1) / (9 * cin) ** 0.5
        dy = torch.randn(batch, cout, h, h, generator=gen, device=device)
        for direction, (xx, ww) in (("forward", (x, wt)), ("dx", (dy, flip_transpose(wt)))):
            w_hwio = ww.permute(2, 3, 1, 0).contiguous()
            ci, co = ww.shape[1], ww.shape[0]
            for inst in ("f32", "tf32"):
                ys = {name: torch.empty(batch, co, h, h, device=device) for name in libs}

                def launch(name):
                    y = ys[name]
                    err = libs[name].conv3x3_packed_launch(
                        xx.data_ptr(), w_hwio.data_ptr(), y.data_ptr(), MODES[inst], batch, h,
                        h, ci, co, *xx.stride(), *y.stride(), stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")

                for name in libs:
                    launch(name)
                torch.cuda.synchronize()
                differ = [n for n in libs if not torch.equal(ys[n], ys[names[0]])]
                if differ:
                    raise RuntimeError(f"{differ} differ from {names[0]} at {ci}->{co}, {h}²")
                ms = {}
                for order in (names, names[::-1]):
                    for name in order:
                        ms.setdefault(name, []).append(
                            chip_smoke.cuda_ms(lambda: launch(name), warmup=3,
                                               iters=args.iters))
                print(json.dumps({"instance": inst, "dir": direction, "cin": ci, "cout": co,
                                  "h": h, "b": batch,
                                  "bound_ms": chip_smoke.conv_bound(batch, h, h, ci, co,
                                                                    inst)[0],
                                  "ms": ms}), flush=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
