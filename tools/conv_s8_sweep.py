#!/usr/bin/env python3
"""Sweep the instances of the port's int8 convolution kernel on one CUDA card.

Builds `medical_image_editing_tpu_torch/csrc/conv_s8.cu` with a list of
candidate instances (the kernel: 0 conv_s8_kernel, 1 conv_s8_kernel_rows;
BN output channels a block, KC 32-byte chunks of K a stage or the row
kernel's kernel rows a step, STAGES in the shared-memory ring, PREFETCH
stages loaded ahead, MINB blocks an SM for the register budget) in place
of its CONV_S8_INSTANCES, f32 output only, and runs each at every distinct
convolution of the lung decoder at 512², batch 8 (the shapes of
`chip_smoke.py`'s int8 phase) that it takes (the row kernel: Wo a
multiple of 64, a 3×3 kernel): its output held bit for bit to the shipped
instance's (`ops/quantized_conv.py::conv_s8`), then timed with CUDA
events. Each candidate runs in every source variant of SOURCE_VARIANTS (a
change of the kernels' code to weigh: the shipped source, and the source
without a line). Prints one JSON line a shape and, last, the per-decode sum
of each candidate over the shapes of its output-channel class that it
takes.

    python3 tools/conv_s8_sweep.py [--iters 30] [--variants shipped,...] [--out DIR]

The sources, libraries and ptxas reports go to DIR (default: the package's
ignored build directory, `_build/conv_s8_sweep`).

Needs a CUDA card and nvcc; imports neither JAX nor the JAX package.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

from sweep_build import build_variants, edited

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (kernel, BN, KC, STAGES, PREFETCH, MINB); KC of the row kernel: its
# kernel rows a step
CANDIDATES = [
    (0, 32, 2, 4, 2, 2), (0, 64, 2, 4, 2, 2), (0, 128, 2, 4, 2, 2),
    (1, 32, 1, 4, 3, 2), (1, 64, 1, 4, 3, 2), (1, 128, 1, 4, 3, 2), (1, 128, 1, 4, 2, 2),
    (1, 32, 3, 2, 1, 2), (1, 32, 3, 2, 1, 4), (1, 32, 3, 3, 2, 2), (1, 32, 3, 3, 1, 2),
    (1, 64, 3, 2, 1, 2), (1, 64, 3, 3, 2, 2),
    (1, 128, 3, 2, 1, 2), (1, 128, 3, 3, 2, 2), (1, 128, 3, 3, 2, 1),
]
SMEM_LIMIT = 232448


def takes(cand, cin, cout, k, d, w):
    """Whether candidate `cand` runs the convolution (the row kernel's
    conditions and shared memory, as `launch_row` checks them)."""
    from medical_image_editing_tpu_torch.ops.quantized_conv import padded_channels, row_kernel_smem

    kernel, bn, kys, stages, _, _ = cand
    if kernel == 0:
        return True
    return (k == 3 and w % 64 == 0 and 64 + 2 * d <= 128 and k % kys == 0
            and row_kernel_smem(bn, kys, stages, padded_channels(cin), k, d) <= SMEM_LIMIT)


def cout_class(cout):
    return 32 if cout <= 32 else 64 if cout <= 64 else 128


# name: [(text, replacement), ...] applied to the source before the instances
SOURCE_VARIANTS = {
    "shipped": [],
    "no_proxy_fence": [('    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");'
                        '  // visible to wgmma\n', "")],
}


def sweep_source(src: str, edits=()) -> str:
    """conv_s8.cu with CANDIDATES as its instances and f32 output alone,
    changed by `edits` ((text, replacement): every occurrence)."""
    src = edited(src, edits, "conv_s8")
    lines = "".join(f"  X({', '.join(map(str, c))}) \\\n" for c in CANDIDATES)
    out, n = re.subn(r"#define CONV_S8_INSTANCES\(X\) \\\n(?:  X\([^)]*\)[ \\]*\n)+",
                     "#define CONV_S8_INSTANCES(X) \\\n" + lines + "\n", src)
    if n != 1:
        raise SystemExit("CONV_S8_INSTANCES not found in conv_s8.cu")
    for t in ("__nv_bfloat16", "int"):
        call = f"launch_instance<{t}>(kernel, bn, kc, stages, prefetch, x8, w8, ks, b, y"
        if call not in out:
            raise SystemExit(f"{call} not found in conv_s8.cu")
        out = re.sub(re.escape(call) + r",\s*s, st\)", "(int)cudaErrorInvalidValue", out)
    return out


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
    from medical_image_editing_tpu_torch.cli.run_recon import load_model
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops import quantized_conv as qc

    if not torch.cuda.is_available():
        print("conv_s8_sweep: no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out) if args.out else _build.BUILD_DIR / "conv_s8_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "conv_s8.cu").read_text()
    libs = {name: lib for name, (lib, _, _) in build_variants(
        {name: sweep_source(src, SOURCE_VARIANTS[name]) for name in args.variants.split(",")},
        out, "conv_s8").items()}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.conv_s8_launch.argtypes = [vp] * 5 + [i] * 19 + [vp]
        lib.conv_s8_launch.restype = i

    model = json.loads(chip_smoke.MODEL_CONFIG.read_text())["model"]["vqmodel"]
    _, decoder, _ = load_model(chip_smoke.lung_config(model), device="cpu", seed=args.seed)
    calls = chip_smoke.decoder_conv_calls(
        decoder, torch.zeros(1, int(model["enc_filters"][0]), 512, 512))
    per_decode = {}
    for c in calls:
        per_decode[c] = per_decode.get(c, 0) + 1
    device, batch = torch.device("cuda"), 8
    gen = torch.Generator(device=device).manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    sums = {(name, cand): 0.0 for name in libs for cand in CANDIDATES}
    for (cin, cout, k, d, pad, h, w, bias), n_calls in per_decode.items():
        x = torch.randn(batch, cin, h, w, generator=gen, device=device)
        wt = torch.randn(cout, cin, k, k, generator=gen, device=device) / (k * k * cin) ** 0.5
        b = torch.randn(cout, generator=gen, device=device) if bias else None
        wq, k_scale, x_scale = qc.conv_s8_weights(wt, qc.channel_absmax(x))
        xq = qc.quantize_s8(x, x_scale)
        geo = dict(kernel_size=(k, k), dilation=(d, d), padding=(pad, pad))
        want = qc.conv_s8(xq, wq, k_scale, b, **geo)
        rec = {"cin": cin, "cout": cout, "kernel": k, "dilation": d, "h": h,
               "calls_per_decode": n_calls,
               "shipped": list(qc.conv_s8_instance(cout, xq.shape[-1], k, k, d, w)),
               "bound_ms": chip_smoke.s8_conv_bound(batch, h, w, cin, cout, k, k, 4, bias)[0],
               "ms": {}}
        for name, cand in sums:
            if not takes(cand, cin, cout, k, d, w):
                continue
            lib = libs[name]
            kernel, bn, kc, stages, prefetch, _ = cand
            y = torch.empty_like(want)

            def launch():
                err = lib.conv_s8_launch(xq.data_ptr(), wq.data_ptr(), k_scale.data_ptr(),
                                         None if b is None else b.data_ptr(), y.data_ptr(), 0,
                                         batch, h, w, xq.shape[-1], cout, h, w, k, k, d, d,
                                         pad, pad, kernel, bn, kc, stages, prefetch, stream)
                if err:
                    raise RuntimeError(f"{cand}: cudaError {err}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise RuntimeError(f"{name} {cand} differs from the shipped instance at {rec}")
            ms = chip_smoke.cuda_ms(launch, warmup=3, iters=args.iters)
            rec["ms"][f"{name}:" + "x".join(map(str, cand))] = ms
            if cout_class(cout) == bn:
                sums[name, cand] += n_calls * ms
        print(json.dumps(rec), flush=True)
    print(json.dumps({"per_decode_ms_by_class": {
        f"{name}:" + "x".join(map(str, c)): v for (name, c), v in sums.items() if v},
        "card": chip_smoke.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
