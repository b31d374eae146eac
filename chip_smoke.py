#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`medical_image_editing_tpu_torch`) on
one CUDA card: the quickest proof that the port starts on the GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line and raising on failure (exit code != 0,
and no result line):
  1. device  — card name and count, `nvidia-smi` name and power limit; TF32
               off for cuDNN convolutions and matmuls (the f32 path is full f32);
  2. build   — every kernel under `medical_image_editing_tpu_torch/csrc` built
               with nvcc for sm_90a; the `-Xptxas -v` report;
  3. kernel  — each kernel against its plain PyTorch version at the shapes of
               the JAX package's operating points and a ragged N, then timed
               with CUDA events beside the plain version and its bound;
  4. serve   — the editing service at the lung model's full widths (from
               `configs/lung_first_stage.json`), seeded weights, f32, 512²:
               encode synthetic slices through `make_eval_forward` (the fused
               VQ kernel), write and paint the label maps, decode them through
               `edit_study`, single-slice `make_edit_fn` requests and a uint8
               batch, and hold the card's encode+decode to the port's CPU path
               on a small input.
               Launch counts are zeroed just before and read just after;
  5. profile — device time by kernel of a warm eval forward and a warm
               painted-map decode;
  6. kernels — one line listing every hand-written kernel of the path.
The last line is `{"ok": true, "device": {...}}`. There is no CPU fallback:
without a CUDA device the script fails at once.
"""

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
MODEL_CONFIG = ROOT / "configs" / "lung_first_stage.json"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# (N, C, K): the serve encode (8 slices at 512², C=16, K=10) first, then the
# JAX package's VQ operating points and a ragged N
VQ_POINTS = [
    (8 * 512 * 512, 16, 10),
    (524288, 16, 10),
    (8192, 512, 64),
    (32768, 64, 512),
    (1000003, 16, 10),
]
VQ_SOURCE = "medical_image_editing_tpu_torch/csrc/vq_fused.cu"
VQ_REPLACES = "medical_image_editing_tpu/ops/vq_pallas.py:29"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=5, iters=50):
    """Mean device time of fn() in ms over `iters` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def vq_bound(n, c, k):
    """Least time (ms) for the fused VQ function on the card, and what bounds
    it: each input read once (features, codebook), each output written once
    (ids, quantized rows, counts, sums); operations 2·N·K·C for the scores
    plus N·C for the sums."""
    nbytes = 4 * (n * c + k * c) + 4 * (n + n * c + k + k * c)
    ops = 2 * n * k * c + n * c
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def device_phase():
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(info)
    return info


def build_phase():
    from medical_image_editing_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    report = {}
    for stem in _build.sources():
        lines = [ln.strip() for ln in _build.ptxas_report(stem).splitlines()
                 if "ptxas info" in ln or "spill" in ln]
        report[stem] = lines
    emit({"phase": "build", "seconds": seconds, "ptxas": report})


def kernel_phase(device, points=VQ_POINTS, seed=0, iters=50):
    """The fused VQ kernel vs its plain version at each point; returns the
    first point's record (the serve encode shape)."""
    import torch

    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.ops.vq_fused import (
        vq_assign_fused,
        vq_assign_fused_reference,
    )

    records = []
    gen = torch.Generator(device=device).manual_seed(seed)
    for n, c, k in points:
        x = torch.randn(n, c, generator=gen, device=device)
        e = torch.randn(k, c, generator=gen, device=device)
        got = vq_assign_fused(e, x)
        again = vq_assign_fused(e, x)
        plain = vq_assign_fused_reference(e, x)
        torch.cuda.synchronize()
        ids = got[0].long()

        top2 = vq_scores(e, x).topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2.abs().max()
        differ = got[0] != plain[0]
        clear_mismatch = int((differ & clear).sum())
        near_tie_mismatch = int((differ & ~clear).sum())
        segment = torch.zeros(k, c, dtype=torch.float64, device=device).index_add_(
            0, ids, x.double())
        sums_err = float((got[3].double() - segment).abs().max())
        sums_tol = 1e-5 * float(x.abs().sum())
        checks = {
            "ids": clear_mismatch == 0,
            "quant": bool(torch.equal(got[1], e[ids])),
            "counts": bool(torch.equal(
                got[2], torch.bincount(ids, minlength=k).float())),
            "sums": sums_err <= sums_tol,
            "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
        }
        ms = cuda_ms(lambda: vq_assign_fused(e, x), iters=iters)
        plain_ms = cuda_ms(lambda: vq_assign_fused_reference(e, x), iters=iters)
        bound_ms, bound_by = vq_bound(n, c, k)
        rec = {
            "phase": "kernel", "name": "vq_fused", "n": n, "c": c, "k": k,
            "checks": checks, "id_mismatches_clear": clear_mismatch,
            "id_mismatches_near_tie": near_tie_mismatch,
            "sums_max_abs_err": sums_err, "sums_tol": sums_tol,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_share": bound_ms / ms,
        }
        emit(rec)
        if not all(checks.values()):
            raise RuntimeError(f"vq_fused disagrees with its plain version at "
                               f"N={n}, C={c}, K={k}: {checks}")
        records.append(rec)
    return records[0]


def make_slices(rng, n, size):
    """Gaussian "nodules" on an intensity gradient, in [-1, 1] (as
    tools/demo_edit.py makes its test images)."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(n):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.03, 0.07), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img, -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def paint(ids, rng, dict_size):
    """Insert a disc of one id and clear a band to background (0)."""
    ids = np.array(ids, dtype=np.int32)
    _, h, w = ids.shape
    yy, xx = np.mgrid[0:h, 0:w]
    for m in ids:
        cy, cx = rng.integers(h // 4, 3 * h // 4, 2)
        m[(yy - cy) ** 2 + (xx - cx) ** 2 <= (h // 16) ** 2] = rng.integers(1, dict_size + 1)
        m[: h // 8] = 0
    return ids


def lung_config(model):
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig

    cfg = LungConfig()
    cfg.resume_checkpoint = None
    cfg.edited_file_path = "label_edit.nii.gz"
    cfg.in_channels = int(model["in_channels"])
    cfg.enc_filters = tuple(model["enc_filters"])
    cfg.dec_filters = tuple(model["dec_filters"])
    cfg.dict_size = int(model["dict_size"])
    cfg.knn_backend = str(model["knn_backend"])
    cfg.use_pixel_shuffle = bool(model["use_pixel_shuffle"])
    cfg.dropped_skip_layers = tuple(model["dropped_skip_layers"])
    return cfg


def serve_phase(device, model, workdir, *, size=512, slices=8, requests=3, seed=0):
    """The editing loop at `model` widths: encode → label maps → paint →
    decode. Returns the kernel launch counts of this run, and the encode and
    decode functions with their inputs for profiling."""
    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import (
        edit_study,
        make_batched_edit_fn,
    )
    from medical_image_editing_tpu_torch.cli.run_recon import (
        load_model,
        make_edit_fn,
    )
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.evaluate import make_eval_forward
    from medical_image_editing_tpu_torch.utils import nifti

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = lung_config(model)
    window = (cfg.window_width, cfg.window_center, cfg.window_scale)
    encoder, decoder, vq_state = load_model(cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    images = make_slices(rng, slices, size)
    workdir = Path(workdir)
    label_dir, out_dir = workdir / "labels", workdir / "edited"
    label_dir.mkdir(parents=True, exist_ok=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _build.launches.clear()
    # -- main path: encode
    forward = make_eval_forward(encoder, decoder, device=device)
    encode_s = []
    for _ in range(2):  # the first call also pays cuDNN's algorithm choice
        t0 = time.perf_counter()
        recon, ids = forward(images)
        sync()
        encode_s.append(time.perf_counter() - t0)
    ids = ids.cpu().numpy()
    recon = recon.cpu().numpy()
    if ids.shape != (slices, size, size) or ids.min() < 1 or ids.max() > cfg.dict_size:
        raise RuntimeError(f"label maps {ids.shape} in [{ids.min()}, {ids.max()}]")
    if recon.shape != images.shape or not np.isfinite(recon).all():
        raise RuntimeError("encode-side reconstruction is not finite")

    # -- label maps out, painted, back in
    painted = paint(ids, rng, cfg.dict_size)
    for i, m in enumerate(painted):
        nifti.save(nifti.to_nifti_array(m), str(label_dir / f"label_{i:04d}.nii.gz"),
                   dtype=np.int32)

    # -- main path: decode (batch of the study, single-slice requests, uint8)
    t0 = time.perf_counter()
    written = edit_study(decoder, vq_state, str(label_dir), str(out_dir),
                         batch_size=slices, is_lung=True, dataset_window=window,
                         device=device)
    sync()
    study_s = time.perf_counter() - t0
    edited = np.stack([nifti.load(str(out_dir / f)) for f in written])
    if edited.shape != (slices, size, size) or not np.isfinite(edited).all():
        raise RuntimeError(f"edited study {edited.shape} not finite / wrong shape")
    if edited.min() < -1.0 or edited.max() > 1.0:
        raise RuntimeError(f"edited values outside [-1, 1]: {edited.min()}, {edited.max()}")

    edit_fn = make_edit_fn(decoder, vq_state, cfg, device=device)
    latencies = []
    for m in painted[:requests]:
        t0 = time.perf_counter()
        rec, mask = edit_fn(m[None])  # numpy out: the request has finished
        latencies.append(time.perf_counter() - t0)
        if rec.shape != (1, size, size) or not np.isfinite(rec).all():
            raise RuntimeError("edit request output not finite / wrong shape")
        if rec.min() < -1.0 or rec.max() > 1.0:
            raise RuntimeError("edit request output outside [-1, 1]")
        if not np.array_equal(mask[0] == 0, m == 0):
            raise RuntimeError("the decode's background mask does not follow label 0")

    edit_u8 = make_batched_edit_fn(decoder, is_lung=True, dataset_window=window,
                                   output_dtype="uint8", device=device)
    edit_f32 = make_batched_edit_fn(decoder, is_lung=True, dataset_window=window,
                                    device=device)
    t0 = time.perf_counter()
    u8 = edit_u8(vq_state, painted).cpu().numpy()
    u8_s = time.perf_counter() - t0
    f32 = edit_f32(vq_state, painted).cpu().numpy()
    if u8.dtype != np.uint8 or u8.shape != (slices, size, size):
        raise RuntimeError(f"uint8 batch {u8.dtype} {u8.shape}")
    lsb = np.abs(u8.astype(np.int16) - ((np.clip(f32, -1, 1) + 1) * 127.5).astype(np.int16))
    if lsb.max() > 1:
        raise RuntimeError(f"uint8 batch off its f32 decode by {lsb.max()} LSB")
    sync()
    launches = dict(_build.launches)

    if cuda and launches.get("vq_fused", 0) == 0:
        raise RuntimeError("the encode did not launch the vq_fused kernel")

    # -- the card's path vs the port's CPU path on a small input
    side = max(size // 4, 32)
    small = images[:1, :side, :side]
    ref_forward = make_eval_forward(copy.deepcopy(encoder), copy.deepcopy(decoder),
                                    device="cpu")
    r_dev, i_dev = forward(small)
    r_cpu, i_cpu = ref_forward(small)
    id_agree = float((i_dev.cpu() == i_cpu).float().mean())
    recon_err = float((r_dev.cpu() - r_cpu).abs().max()) if id_agree == 1.0 else None
    if id_agree < 0.999 or (recon_err is not None and recon_err > 1e-3):
        raise RuntimeError(f"card vs CPU path: ids agree {id_agree}, recon err {recon_err}")

    rec = {
        "phase": "serve", "device": str(device), "size": size, "slices": slices,
        "enc_filters": list(cfg.enc_filters), "dec_filters": list(cfg.dec_filters),
        "dict_size": cfg.dict_size, "knn_backend": cfg.knn_backend,
        "encode_batch_s": encode_s, "edit_study_s": study_s,
        "edit_request_s": latencies, "uint8_batch_s": u8_s,
        "launches": launches, "files_written": len(written),
        "cpu_reference_id_agreement": id_agree, "cpu_reference_recon_max_abs_err": recon_err,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "card": nvidia_smi() if cuda else None,
    }
    emit(rec)
    served = SimpleNamespace(forward=forward, edit=edit_f32, vq_state=vq_state,
                              images=images, painted=painted)
    return launches, served


def profile_phase(served):
    """Device time by kernel of one warm eval forward (encode + VQ + decode
    of the image) and one warm batched painted-map decode (torch.profiler),
    the device's busy share of each window, and the fused VQ kernel's part."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    steps = (("eval_forward", lambda: served.forward(served.images)),
             ("edit_decode", lambda: served.edit(served.vq_state, served.painted)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)  # the profiler's own start-up
        torch.cuda.synchronize()
    for name, fn in steps:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(device_us(e) for e in kernels) / 1e6
        vq = sum(device_us(e) for e in kernels if "vq_" in e.key) / 1e6
        top = sorted(kernels, key=device_us, reverse=True)[:8]
        emit({
            "phase": "profile", "step": name, "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "vq_fused_device_s": vq,
            "top": [{"kernel": e.key[:90], "count": e.count,
                     "device_s": device_us(e) / 1e6} for e in top],
        })


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    info = device_phase()
    build_phase()
    vq = kernel_phase("cuda", seed=args.seed)
    model = json.loads(MODEL_CONFIG.read_text())["model"]["vqmodel"]
    with tempfile.TemporaryDirectory() as tmp:
        launches, served = serve_phase("cuda", model, tmp, seed=args.seed)
    profile_phase(served)
    emit({"kernels": [{
        "name": "vq_fused", "route": "cuda", "source": VQ_SOURCE,
        "replaces": VQ_REPLACES, "launches": launches.get("vq_fused", 0),
        "max_abs_err": vq["sums_max_abs_err"],
        "id_mismatches_near_tie": vq["id_mismatches_near_tie"],
        "n": vq["n"], "c": vq["c"], "k": vq["k"],
        "ms": vq["ms"], "plain_ms": vq["plain_ms"], "bound_ms": vq["bound_ms"],
        "bound_by": vq["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes assign + lookup + "
                        "per-code counts and sums",
    }]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
