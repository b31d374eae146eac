#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`medical_image_editing_tpu_torch`) on
one CUDA card: the quickest proof that the port starts on the GPU.

    python3 chip_smoke.py [--seed 0] [--kernel-only]

Phases, each printing one JSON line and raising on failure (exit code != 0,
and no result line):
  1. device  — card name and count, `nvidia-smi` name and power limit;
               MEDIMG_CONV_PRECISION=ieee for the whole run, applied as the
               CLIs apply it: TF32 off for cuDNN convolutions and matmuls
               (the f32 path is full f32; every CLI call and card-vs-CPU
               part checks it off again);
  2. build   — every kernel under `medical_image_editing_tpu_torch/csrc` built
               with nvcc for sm_90a (one nvcc per source, all at once); the
               `-Xptxas -v` report;
  3. kernel  — the fused VQ kernel against its plain PyTorch version at the
               serve encode point, the JAX package's operating points and a
               ragged N; timed with CUDA events (`ms`) and the profiler
               (`device_ms`, the cross-block reduce included) beside the
               plain version and its bound; the instance that ran (`path`)
               and hashes of its ids and quantized rows;
  4. conv    — the 3×3 conv kernel, forward and input gradient, against its
               plain version (and dx against autograd through `F.conv2d`) at
               every (Cin, Cout, H) the training step gives it, batch 8, f32
               (CUDA-core path) and bf16 (tensor-core path, mma.sync), plus a
               ragged shape; timed beside the plain version, cuDNN's
               `F.conv2d` (`vs_library` = kernel / cuDNN) and its bound,
               with CUDA events around 50 calls (`ms`: what a caller waits,
               the wrapper's host work included) and with the profiler
               (`device_ms`: the kernel's own device time);
  5. serve   — the editing service at the lung model's full widths (from
               `configs/lung_first_stage.json`), seeded weights, f32, 512²:
               encode synthetic slices through `make_eval_forward` (the fused
               VQ kernel), write and paint the label maps, decode them through
               `edit_study`, single-slice `make_edit_fn` requests and a uint8
               batch, and hold the card's encode+decode to the port's CPU path
               on a small input;
  6. profile — device time by kernel of a warm eval forward and a warm
               painted-map decode;
  6b. serve_runtime — the editing service's runtime at the same widths,
               512²: (a) the painted batch of 8 decoded in f32, in bf16 on
               cuDNN and in bf16 on the packed conv kernel (times, device
               time, error against f32, conv launches held to the count
               derived from the model), single-slice requests per route;
               (b) the HTTP service (`cli/serve_http.py`, bf16, packed) on a
               local port: healthz, edits, a padded batch, a PNG and three
               requests that must get 400; (c) the file-watching loop
               (`cli/run_recon.py::serve`, inotify) answering three edits;
  7. train   — the first-stage training step at the same widths, with the
               config's augmentation, losses, optimizers and bf16 compute
               dtype, `MEDIMG_CONV_IMPL=packed`, 256², batch 8: codebook
               k-means on the first batch (`init_codebook_step`), then 5 steps
               (`make_first_stage_step`); the launch counts of both kernels
               held to the counts derived from the model; one warm step under
               the profiler; one step on the card held to the port's CPU path
               on a small input;
  8. trainer — the first-stage training run as a user runs it,
               `run_vqwnet.main` in-process with `MEDIMG_CONV_IMPL=packed`
               on the lung config (widths, losses, bf16, batch 8, 256²)
               over a seeded slice tree of 2 patients × 20 slices read by
               the native loader: run A trains 10 steps (2 epochs, saves
               every 3 steps, steps 7-9 profiled); run B stops at 7 and
               resumes to 10, held to A (slice order, counters, parameter
               and codebook gap); `-m test` writes result.csv; the
               "inference" export writes label maps, one of which is
               painted and decoded through `edit_study`; launch counts of
               both kernels held to the derived ones; fit-loop step time
               beside the train phase's bare step, loader and save times,
               idle share, peak memory;
  8b. second_stage — the second (adversarial) stage at the widths of
               `configs/lung_second_stage.json` (bf16 encoder and decoder,
               the f32 U-Net discriminator at D_ch 64, packed conv, 256²,
               batch 8): (a) 5 bare steps of `make_second_stage_step`
               after the codebook k-means, launch counts held to the derived
               ones; a profiled warm step (busy, idle, top kernels), the
               discriminator's work alone under the profiler (its share of
               busy, its f32 rate against the operations counted from the
               model), peak memory, a warm step with cuDNN's TF32 on (time,
               loss gap); one step on the card held to the CPU path on a
               small input; (b) `run_vqwnet.main` on the second-stage config
               staged from the trainer phase's run-A first stage: run A 6
               steps, run B 3 and a resume to 6 held to A (slice order,
               counters, parameters, moments and spectral-norm vectors),
               validation grids with the discriminator's maps, `-m test`,
               the export, a painted decode with the second-stage decoder,
               launch counts held to the derived ones, and a planted faulty
               resume (the discriminator's Adam state and spectral-norm
               vectors dropped) whose gap is printed;
  8c. multi_window — the multi-window trainer at the widths of
               `configs/lung_multiwindow_joint.json` (bf16 encoder and
               decoder, the f32 U-Net discriminator at D_ch 64, packed conv,
               256², batch 8): (a) k-means, then 5 bare joint steps (two
               views, 6 generator-pass and 18 discriminator-pass forwards
               of the discriminator), launch counts held to the derived
               ones, peak memory, a profiled warm step (busy, idle, top
               kernels), the discriminator's work alone (its share of busy,
               its f32 rate against the operations counted from the model);
               2 bare steps each of the multi-window first and second
               steps, launches held; (c) one joint step on the card held to
               the CPU path on a small input; (b) `run_vqwnet.main -w` over
               the trainer phase's tree: run A 6 steps, run B 3 and a
               resume to 6 held to A within MW_RESUME_GAP_LIMIT, validation
               grids with the discriminator's maps, `-m test` (the HU NIfTI
               export), a painted decode of an exported label map, launches
               held, and a planted faulty resume whose gap is printed;
  8d. vqgan — the VQGAN trainer at the widths of `configs/crc_vqgan.json`
               (f32 VQGAN, 126 M parameters, its 64 × 512 codebook on the VQ
               kernel's generic instance; the f32 U-Net discriminator at
               D_ch 64, resolution 512), `MEDIMG_CONV_IMPL=packed` (no
               convolution routes to the conv kernel: 0 launches, held),
               512², batch 8: (a) 5 bare steps of `make_vqgan_step`,
               launches held (one assignment a step, the instance seen by
               the profiler), peak memory, a profiled warm step (busy, idle,
               top kernels, the VQ kernel's share), the discriminator's work
               and the VQGAN's forward and backward alone (shares of busy,
               f32 rates against the operations counted from the models), a
               painted 16² bottleneck map decoded through
               `generate_image_from_ids`; (c) one step at 128², batch 2, f32,
               on the card held to the CPU path; (b) `run_vqwnet.main -v`
               over a seeded CRC tree of 2 × 20 slices of 512²: run A 6
               steps, run B 3 and a resume to 6 held to A within
               VQGAN_RESUME_GAP_LIMIT, `-m test` (result.csv), the
               "inference" export of the 0-based label maps, launches held,
               and a planted faulty resume (the codebook's EMA buffers
               dropped) whose gap is printed;
  8e. losses — the perceptual loss and DropBlock on the lung first stage's
               path (`configs/lung_first_stage.json` at full widths with
               only the switches on: the VGG19 loss at weight 1.0 on its
               seeded fallback, DropBlock at block_size 30), bf16, packed,
               256², batch 8: (a) k-means and 5 bare steps at drop_prob
               0.5, launches held to the train phase's derived counts, a
               profiled warm step, the VGG's work alone (device time, share
               of busy, f32 rate against the operations counted on the meta
               device), peak memory, a warm step under `tf32` against
               `ieee` (times, loss gap); (b) 2 steps with LPIPS, launches
               held; (c) the VQGAN step at `configs/crc_vqgan.json`'s full
               widths, 512², batch 8, with the VGG loss: 3 steps, peak
               memory; (d) one step at 64², batch 2, f32, `ieee`, on the
               card held to the CPU path; (e) `run_vqwnet.main` over the
               trainer phase's tree: run A 10 steps, run B 3 and a resume
               across the epoch end held to A with a gap of 0, the logged
               `perceptual_fallback`, each step's drop_prob against the
               schedule, the checkpoint keys, launches held, and the
               precision the CLIs set by default;
  9. kernels — one line listing every hand-written kernel of the paths.
The serve, serve_runtime (its packed route), train, trainer, second_stage
(a) and (b), multi_window (a) (each mode) and (b), vqgan (a) and (b), and
losses (a), (b), (c) and (e) phases are the main paths: each zeroes the
launch counts just before it and reads them just after.
`--kernel-only` runs phases 1-3 for the VQ kernel alone and prints no
result line: run from two checkouts in one call (this script copied into
the other), it holds two versions of the kernel to each other by time and,
through the hashes, bit for bit.
The last line is `{"ok": true, "device": {...}}`. There is no CPU fallback:
without a CUDA device the script fails at once.
"""

import argparse
import contextlib
import copy
import csv
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
MODEL_CONFIG = ROOT / "configs" / "lung_first_stage.json"
SECOND_CONFIG = ROOT / "configs" / "lung_second_stage.json"
MW_CONFIG = ROOT / "configs" / "lung_multiwindow_joint.json"
VQGAN_CONFIG = ROOT / "configs" / "crc_vqgan.json"
# the resumed second-stage run against the uninterrupted one
# (`second_stage_run_part.state_gap`), each limit between the gaps measured
# on an H100 (resume; planted fault): the discriminator's parameters RMS
# 0.0079 lr; 1.72 lr, its Adam moments 0.0031; 0.88, its spectral-norm
# vectors 3.3e-4; 2.0, the decoder's moments 0.0105; 0.123. The card's f32
# weight-gradient sums are not reproducible run to run, and the bf16
# decoder's Adam steps turn with them: its parameters' RMS gap (0.54 lr)
# sits near the planted fault's (0.67 lr), which reaches the decoder only
# through the discriminator, so they are held only to 2 lr (the whole
# resumed stretch, 3 steps, were it lost)
SECOND_RESUME_GAP_LIMIT = {
    "decoder": {"params_rms_lr": 2.0, "moments_rel": 0.05},
    "discriminator": {"params_rms_lr": 0.1, "moments_rel": 0.05, "sn_max": 0.03},
}
# the resumed multi-window joint run against the uninterrupted one
# (`multi_window_run_part.state_gap`), each limit between the gaps measured
# on an H100 (resume; planted fault) where the fault reaches the module:
# the discriminator's parameters RMS 0.038 lr; 1.39 lr, its Adam moments
# 0.0069; 1.02, its spectral-norm vectors 0.0043; 2.0. The card's f32
# weight gradients are not reproducible run to run, and the bf16 encoder
# and decoder steps turn with them through the ill-conditioned
# reconstruction gradient: after 3 resumed steps their parameters are 1.70
# and 0.69 lr RMS apart, their moments 0.46-0.48 and 0.043, the codebook
# 0.022-0.050,
# and the planted fault (which reaches them only through the
# discriminator) lands at the same values. They are held only to what a
# lost state would exceed: 2 lr (the whole resumed stretch), moments below
# 1 (all of Adam's state gone), the codebook 0.1
MW_RESUME_GAP_LIMIT = {
    "encoder": {"params_rms_lr": 2.0, "moments_rel": 0.8},
    "decoder": {"params_rms_lr": 2.0, "moments_rel": 0.25},
    "discriminator": {"params_rms_lr": 0.1, "moments_rel": 0.05, "sn_max": 0.03},
    "codebook": {"rel": 0.1},
}
# the resumed VQGAN run against the uninterrupted one
# (`vqgan_run_part.state_gap`), each limit between the gaps measured on an
# H100 (resume; planted fault, the codebook's EMA buffers dropped): the
# VQGAN's parameters RMS 0.015 lr; 0.159 lr, its Adam moments 0.014; 0.133,
# the discriminator's parameters 0.0034 lr; 0.023 lr, its moments 0.024;
# 0.155, its spectral-norm vectors 1.0e-4; 3.4e-3, the codebook's embed
# 4e-10; 1e5, counts 0; 0.46, sums 8.3e-4; 1.8e4 (relative). The card's f32
# weight gradients are not reproducible run to run, so the resume is not
# held to 0
VQGAN_RESUME_GAP_LIMIT = {
    "decoder": {"params_rms_lr": 0.08, "moments_rel": 0.08},
    "discriminator": {"params_rms_lr": 0.015, "moments_rel": 0.1, "sn_max": 0.001},
    "codebook": {"embed": 0.01, "cluster_size": 0.01, "embed_avg": 0.01},
}

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32 outside the
# tensor cores, bf16 on the dense tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

# (N, C, K): the serve encode (8 slices at 512², C=16, K=10) first, then the
# JAX package's VQ operating points, the VQGAN step's (8 × 16² rows against
# its 64 × 512 codebook), a ragged N, and N past one launch's row limit
# (2**24, walked in two chunks)
VQ_POINTS = [
    (8 * 512 * 512, 16, 10),
    (524288, 16, 10),
    (8192, 512, 64),
    (2048, 512, 64),
    (32768, 64, 512),
    (1000003, 16, 10),
    (2**24 + 3, 16, 10),
]
VQ_SOURCE = "medical_image_editing_tpu_torch/csrc/vq_fused.cu"
VQ_REPLACES = "medical_image_editing_tpu/ops/vq_pallas.py:29"

# (Cin, Cout, H = W) of the packed conv's forward launches in the lung
# model's training step at 256² (the dx launch of each is Cout → Cin);
# the first is the decoder's 256² level, the most frequent
CONV_POINTS = [(32, 32, 256), (32, 32, 128), (32, 64, 128), (32, 64, 64)]
# (B, Cin, Cout, H = W) of the bf16 decode's packed convs when serving at
# 512²: a single request and a batch of 8 (bf16 only)
CONV_SERVE_POINTS = [(1, 32, 32, 512), (8, 32, 32, 512)]
CONV_RAGGED = (3, 20, 40, 37, 45)  # B, Cin, Cout, H, W
CONV_SOURCE = "medical_image_editing_tpu_torch/csrc/conv3x3_packed.cu"
CONV_REPLACES = "medical_image_editing_tpu/ops/conv_pack.py:66"
# the source's kernel for each dtype, as the profiler names them
CONV_PATHS = {"float32": ("conv3x3_kernel", "cuda-core f32"),
              "bfloat16": ("conv3x3_mma_kernel", "mma.sync bf16")}


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


def conv_bound(b, h, w, cin, cout, dtype):
    """Least time (ms) for a 3×3 SAME conv on the card, and what bounds it:
    x, the weights and y each moved once; 2·B·H·W·9·Cin·Cout operations at
    the f32 CUDA-core rate, or the dense bf16 tensor-core rate."""
    import torch

    size = torch.finfo(dtype).bits // 8
    nbytes = size * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
    ops = 2 * b * h * w * 9 * cin * cout
    rate = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def _profiled(fn):
    """One call of fn() under torch.profiler, synchronised: (wall s,
    profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return time.perf_counter() - t0, prof


def _cuda_kernels(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_window(fn):
    """One call of fn() under torch.profiler, synchronised: (wall s, CUDA
    kernel events)."""
    wall, prof = _profiled(fn)
    return wall, _cuda_kernels(prof)


def profile_union(fn):
    """As `profile_window`, and the device busy time as the union of the
    kernels' intervals: (wall s, CUDA kernel events, busy s). The union,
    not the sum, is the time the card was busy when kernels overlap
    (cuDNN's FFT convolutions run on more than one stream)."""
    from torch.autograd import DeviceType

    wall, prof = _profiled(fn)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall, _cuda_kernels(prof), busy / 1e6


def device_ms(fn, match=None, iters=20, tries=3, names=None):
    """Device time (ms) of one call of fn(): the kernels of `iters` calls
    under torch.profiler (only those whose name holds `match`, if given),
    over `iters`. Unlike `cuda_ms`, it leaves out the card's idle time while
    the host prepares the next call. A window in which the profiler reports
    no such kernel is taken again; None ("not measured") after `tries`.
    The names of the kernels counted are added to the list `names`."""
    fn()
    for _ in range(tries):
        _, kernels = profile_window(lambda: [fn() for _ in range(iters)])
        found = [e for e in kernels if match is None or match in e.key]
        us = [device_us(e) for e in found]
        if us and sum(us) > 0:
            if names is not None:
                names.extend(e.key for e in found)
            return sum(us) / 1e3 / iters
    return None


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def load_config(path=MODEL_CONFIG):
    from medical_image_editing_tpu_torch.utils.config import load_json

    return load_json(str(path))


@contextlib.contextmanager
def conv_route(impl):
    """MEDIMG_CONV_IMPL=impl inside the block, restored after."""
    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = impl
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_IMPL")
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev


@contextlib.contextmanager
def conv_precision(value):
    """MEDIMG_CONV_PRECISION=value (None: unset) inside the block, applied
    as the CLIs apply it (`utils.device.apply_conv_precision`); the
    variable and the cuDNN and matmul TF32 flags restored after. Yields
    the value applied."""
    import torch

    from medical_image_editing_tpu_torch.utils.device import apply_conv_precision

    prev = os.environ.get("MEDIMG_CONV_PRECISION")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if value is None:
        os.environ.pop("MEDIMG_CONV_PRECISION", None)
    else:
        os.environ["MEDIMG_CONV_PRECISION"] = value
    try:
        yield apply_conv_precision()
    finally:
        if prev is None:
            os.environ.pop("MEDIMG_CONV_PRECISION", None)
        else:
            os.environ["MEDIMG_CONV_PRECISION"] = prev
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def tf32_off():
    """Raise unless cuDNN's f32 convolutions and matmuls are full f32."""
    import torch

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on where the run holds the card to full f32 "
                           f"(cudnn {torch.backends.cudnn.allow_tf32}, "
                           f"matmul {torch.backends.cuda.matmul.allow_tf32})")


def device_phase():
    """The card, and the run's precision: MEDIMG_CONV_PRECISION=ieee for
    the whole process, applied as the CLIs apply it, so that cuDNN's f32
    convolutions and matmuls are full f32 wherever the card is held to the
    CPU or a run to another (a phase that measures TF32 says so)."""
    import torch

    from medical_image_editing_tpu_torch.utils.device import apply_conv_precision

    os.environ["MEDIMG_CONV_PRECISION"] = "ieee"
    apply_conv_precision()
    tf32_off()
    smi = nvidia_smi()
    print(smi, flush=True)
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "conv_precision": os.environ["MEDIMG_CONV_PRECISION"],
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    emit(info)
    return info


def build_phase(stems=None):
    from medical_image_editing_tpu_torch.ops import _build

    stems = _build.sources() if stems is None else stems
    t0 = time.perf_counter()
    _build.build_all(stems)
    seconds = time.perf_counter() - t0
    report = {}
    for stem in stems:
        lines = [ln.strip() for ln in _build.ptxas_report(stem).splitlines()
                 if "ptxas info" in ln or "spill" in ln]
        report[stem] = lines
    emit({"phase": "build", "seconds": seconds, "ptxas": report})


def vq_path(names):
    """The instance of the VQ kernel template the profiler saw launched:
    `vq_assign_kernel<16, 10>` is "c16k10", `<0, 0>` (C and K read from the
    arguments) is "generic"; a kernel that is no such template keeps its name."""
    found = set()
    for name in names:
        m = re.search(r"vq_assign_kernel<(\d+), (\d+)>", name)
        if m:
            found.add("generic" if m.groups() == ("0", "0") else f"c{m[1]}k{m[2]}")
        elif "vq_assign" in name:
            found.add(re.search(r"vq_assign\w*", name)[0])
    return "+".join(sorted(found)) or None


def kernel_phase(device, points=VQ_POINTS, seed=0, iters=50):
    """The fused VQ kernel vs its plain version at each point; returns the
    records, the serve encode shape first. `ms` is CUDA events around
    `iters` wrapper calls (the wrapper's host work included), `device_ms`
    the profiler's device time of the kernels (`vq_` in the name, the
    cross-block reduce included); `ids_sha256` and `quant_sha256` let two
    builds of the kernel be held bit for bit on the same seeded inputs."""
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
        seen = []
        dev_ms = device_ms(lambda: vq_assign_fused(e, x), "vq_", names=seen)
        bound_ms, bound_by = vq_bound(n, c, k)
        rec = {
            "phase": "kernel", "name": "vq_fused", "n": n, "c": c, "k": k,
            "path": vq_path(seen),
            "checks": checks, "id_mismatches_clear": clear_mismatch,
            "id_mismatches_near_tie": near_tie_mismatch,
            "sums_max_abs_err": sums_err, "sums_tol": sums_tol,
            "ms": ms, "device_ms": dev_ms, "host_gap_ms": None if dev_ms is None else ms - dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_share": bound_ms / ms,
            "roofline_share_device": None if not dev_ms else bound_ms / dev_ms,
            "ids_sha256": hashlib.sha256(got[0].cpu().numpy().tobytes()).hexdigest()[:16],
            "quant_sha256": hashlib.sha256(got[1].cpu().numpy().tobytes()).hexdigest()[:16],
        }
        emit(rec)
        if not all(checks.values()):
            raise RuntimeError(f"vq_fused disagrees with its plain version at "
                               f"N={n}, C={c}, K={k}: {checks}")
        records.append(rec)
        del x, e, got, again, plain, top2, segment
    return records


def conv_kernel_phase(device, points=CONV_POINTS, batch=8, seed=0, iters=50):
    """The 3×3 conv kernel vs its plain version, forward and dx, at each
    point in f32 and bf16 and at a ragged shape; returns the records."""
    import torch
    import torch.nn.functional as F

    from medical_image_editing_tpu_torch.ops.conv_pack import (
        conv3x3_packed,
        conv3x3_packed_nchw,
        conv3x3_packed_reference_nchw,
        flip_transpose,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    b0, cin0, cout0, h0, w0 = CONV_RAGGED
    cases = [(batch, cin, cout, h, h, dt) for cin, cout, h in points
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(b, cin, cout, h, h, torch.bfloat16) for b, cin, cout, h in CONV_SERVE_POINTS]
    cases += [(b0, cin0, cout0, h0, w0, dt) for dt in (torch.bfloat16, torch.float32)]
    records = []
    for b, cin, cout, h, w, dt in cases:
        x = torch.randn(b, cin, h, w, generator=gen, device=device).to(dt)
        wt = ((torch.rand(cout, cin, 3, 3, generator=gen, device=device) * 2 - 1)
              / (9 * cin) ** 0.5).to(dt)
        dy = torch.randn(b, cout, h, w, generator=gen, device=device).to(dt)
        wdx = flip_transpose(wt).contiguous()
        got = conv3x3_packed_nchw(x, wt)
        again = conv3x3_packed_nchw(x, wt)
        dx = conv3x3_packed_nchw(dy, wdx)
        nhwc = conv3x3_packed(x.permute(0, 2, 3, 1).contiguous(),
                              wt.permute(2, 3, 1, 0).contiguous())
        # f32 references on the same (rounded) values; dx through autograd
        xr = x.float().requires_grad_()
        ref = F.conv2d(xr, wt.float(), padding=1)
        ref.backward(dy.float())
        torch.cuda.synchronize()
        # f32: sums in another order; bf16: one rounding of the f32 sum
        rel = 2.0**-8 if dt == torch.bfloat16 else 0.0
        fwd_err = float((got.float() - ref.detach()).abs().max())
        dx_err = float((dx.float() - xr.grad).abs().max())
        checks = {
            "forward": bool(((got.float() - ref.detach()).abs()
                             <= rel * ref.detach().abs() + 1e-4).all()),
            "dx": bool(((dx.float() - xr.grad).abs() <= rel * xr.grad.abs() + 1e-4).all()),
            "deterministic": bool(torch.equal(got, again)),
            "nhwc_entry": bool(torch.equal(nhwc.permute(0, 3, 1, 2), got)),
        }
        dtype = str(dt).split(".")[-1]
        rec = {"phase": "conv", "name": "conv3x3_packed", "dtype": dtype,
               "path": CONV_PATHS[dtype][1], "b": b, "cin": cin, "cout": cout, "h": h,
               "w": w, "checks": checks,
               "forward_max_abs_err": fwd_err, "dx_max_abs_err": dx_err,
               "tolerance": f"|err| <= {rel}*|ref| + 1e-4"}
        if (b, h, w) != (b0, h0, w0):
            for name, (xx, ww) in (("forward", (x, wt)), ("dx", (dy, wdx))):
                ci, co = ww.shape[1], ww.shape[0]
                bound_ms, bound_by = conv_bound(b, h, w, ci, co, dt)
                ms = cuda_ms(lambda: conv3x3_packed_nchw(xx, ww), iters=iters)
                library_ms = cuda_ms(lambda: F.conv2d(xx, ww, padding=1), iters=iters)
                rec[name] = {
                    "cin": ci, "cout": co, "ms": ms,
                    "plain_ms": cuda_ms(lambda: conv3x3_packed_reference_nchw(xx, ww),
                                        iters=iters),
                    "library_ms": library_ms, "vs_library": ms / library_ms,
                    "device_ms": device_ms(lambda: conv3x3_packed_nchw(xx, ww),
                                           CONV_PATHS[dtype][0]),
                    "library_device_ms": device_ms(lambda: F.conv2d(xx, ww, padding=1)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "roofline_share": bound_ms / ms,
                }
        emit(rec)
        if not all(checks.values()):
            raise RuntimeError(f"conv3x3_packed disagrees with its plain version at "
                               f"{(b, cin, cout, h, w, dt)}: {checks}")
        records.append(rec)
    return records


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
    from torch.profiler import ProfilerActivity, profile

    steps = (("eval_forward", lambda: served.forward(served.images)),
             ("edit_decode", lambda: served.edit(served.vq_state, served.painted)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)  # the profiler's own start-up
        torch.cuda.synchronize()
    for name, fn in steps:
        fn()
        wall, kernels = profile_window(fn)
        emit({"phase": "profile", "step": name, **kernel_breakdown(wall, kernels)})


def decode_gap(out, ref):
    """Max, mean, 99th and 99.9th percentile abs difference and correlation
    of two decodes."""
    diff = np.abs(out.astype(np.float64) - ref)
    p99, p999 = np.quantile(diff, [0.99, 0.999])
    return {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "p99_abs_err": float(p99), "p999_abs_err": float(p999),
            "corr": float(np.corrcoef(out.ravel(), ref.ravel())[0, 1])}


def serve_runtime_phase(device, model, painted, workdir, *, requests=3, seed=0):
    """The editing service's runtime at `model` widths on the painted maps
    (B, H, W) of the serve phase: (a) bf16 serving on both conv routes
    against f32, (b) the HTTP service, (c) the file-watching loop. Returns
    the launch counts of the packed route's decodes in (a)."""
    launches = serve_bf16_part(device, model, painted, requests=requests, seed=seed)
    with conv_route("packed"):
        serve_http_part(device, model, painted, seed=seed)
        serve_watch_part(device, model, painted, workdir)
    return launches


def serve_bf16_part(device, model, painted, *, requests=3, seed=0):
    """(a) The painted batch decoded three ways with the same seeded
    weights: f32, bf16 with the default route (cuDNN), bf16 with
    `MEDIMG_CONV_IMPL=packed`. Per route: warm decode times (host clock),
    device busy time of one decode (profiler), the gap from the f32 decode
    in lung-window units, the packed conv's launches (0 on the cuDNN routes,
    the derived count per decode on the packed one), `requests` single-slice
    requests through `make_edit_fn`, peak memory. Raises unless the outputs
    are finite in [-1, 1], the packed decode correlates with the cuDNN bf16
    one above 0.99, and its gap from it is no wider than the cuDNN bf16
    decode's gap from f32 (both accumulate bf16 products in f32)."""
    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.run_recon import load_model, make_edit_fn
    from medical_image_editing_tpu_torch.ops import _build

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    size = painted.shape[-1]
    models = {}
    for dtype in (None, "bfloat16"):
        cfg = lung_config(model)
        cfg.compute_dtype = dtype
        models[dtype] = (cfg, *load_model(cfg, device=device, seed=seed)[1:])
    window = (models[None][0].window_width, models[None][0].window_center,
              models[None][0].window_scale)
    with conv_route("packed"):
        n_dec = routed_convs(models["bfloat16"][1],
                             torch.zeros(1, int(model["enc_filters"][0]), size, size))
    outs, launches = {}, {}
    for name, dtype, impl in (("f32", None, "xla"), ("bf16_cudnn", "bfloat16", "xla"),
                              ("bf16_packed", "bfloat16", "packed")):
        cfg, dec, vq_state = models[dtype]
        with conv_route(impl):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            edit = make_batched_edit_fn(dec, is_lung=True, dataset_window=window,
                                        device=device)
            request = make_edit_fn(dec, vq_state, cfg, device=device)
            _build.launches.clear()
            # -- main path (packed route): decodes, then single-slice requests
            outs[name] = edit(vq_state, painted).cpu().numpy()  # cuDNN's choice too
            decode_s = []
            for _ in range(3):
                t0 = time.perf_counter()
                edit(vq_state, painted)
                sync()
                decode_s.append(time.perf_counter() - t0)
            decodes = 4
            profiled = {}
            if cuda:
                wall, kernels = profile_window(lambda: edit(vq_state, painted))
                decodes += 1
                profiled = kernel_breakdown(wall, kernels)
            request_s = []
            for m in painted[:requests]:
                t0 = time.perf_counter()
                request(m[None])
                request_s.append(time.perf_counter() - t0)
            launches[name] = dict(_build.launches)
        out = outs[name]
        conv_launches = launches[name].get("conv3x3_packed", 0)
        want = (decodes + len(request_s)) * n_dec if cuda and impl == "packed" else 0
        rec = {"phase": "serve_runtime", "part": "bf16", "route": name, "size": size,
               "batch": int(painted.shape[0]), "decode_s": decode_s,
               "edit_request_s": request_s,
               "device_busy_s": profiled.get("device_busy_s"),
               "conv3x3_packed_device_s": profiled.get("conv3x3_packed_device_s"),
               "top": profiled.get("top"),
               "vs_f32": decode_gap(out, outs["f32"]),
               "conv3x3_packed_launches": conv_launches,
               "conv3x3_packed_launches_expected": want,
               "routed_convs_per_decode": n_dec,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if cuda else None,
               "card": nvidia_smi() if cuda else None}
        if name == "bf16_packed":
            rec["vs_bf16_cudnn"] = decode_gap(out, outs["bf16_cudnn"])
        emit(rec)
        if not np.isfinite(out).all() or out.min() < -1.0 or out.max() > 1.0:
            raise RuntimeError(f"{name} decode not finite in [-1, 1]")
        if conv_launches != want:
            raise RuntimeError(f"{name}: {conv_launches} conv3x3_packed launches, "
                               f"derived {want}")
    packed = decode_gap(outs["bf16_packed"], outs["bf16_cudnn"])
    cudnn_gap = decode_gap(outs["bf16_cudnn"], outs["f32"])["max_abs_err"]
    if packed["corr"] <= 0.99 or packed["max_abs_err"] > cudnn_gap:
        raise RuntimeError(f"packed bf16 decode vs cuDNN bf16: {packed}; cuDNN bf16 vs "
                           f"f32 max abs {cudnn_gap}")
    return launches["bf16_packed"]


def serve_http_part(device, model, painted, *, seed=0):
    """(b) `EditService` (bf16) behind `ThreadingHTTPServer` on a local port:
    /healthz, one slice, a batch of 3 (padded to 4), a PNG, and a malformed
    body, a label past the codebook and an empty batch, which must get 400.
    The .npy responses must equal `service.edit` on the same maps (1e-6).
    Records each request's host time and X-Edit-Ms."""
    import io
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from medical_image_editing_tpu_torch.cli.serve_http import EditService, make_handler
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils.imaging import PNG_SIGNATURE

    cuda = torch.device(device).type == "cuda"
    size = painted.shape[-1]
    cfg = lung_config(model)
    cfg.compute_dtype = "bfloat16"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    service = EditService(cfg, device=device)
    for b in (1, 4):  # warm the two batch sizes served below
        service.edit(np.zeros((b, size, size), np.int32))
        service.edit(np.zeros((b, size, size), np.int32), uint8=True)

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    calls = []

    def call(path, body=None, expect=200):
        req = urllib.request.Request(url + path, data=body,
                                     method="GET" if body is None else "POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                code, data, edit_ms = r.status, r.read(), r.headers.get("X-Edit-Ms")
        except urllib.error.HTTPError as e:
            code, data, edit_ms = e.code, e.read(), None
        calls.append({"path": path, "status": code,
                      "host_ms": (time.perf_counter() - t0) * 1e3,
                      "x_edit_ms": None if edit_ms is None else float(edit_ms)})
        if code != expect:
            raise RuntimeError(f"{path}: HTTP {code}, expected {expect}: {data[:200]!r}")
        return data

    _build.launches.clear()
    try:
        info = json.loads(call("/healthz"))
        one = np.load(io.BytesIO(call("/edit", npy(painted[0]))))
        three = np.load(io.BytesIO(call("/edit", npy(painted[:3]))))
        png = call("/edit?format=png", npy(painted[0]))
        bad = painted[0].copy()
        bad[0, 0] = cfg.dict_size + 1
        call("/edit", b"not an npy", expect=400)
        call("/edit", npy(bad), expect=400)
        call("/edit", npy(np.zeros((0, size, size), np.int32)), expect=400)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    launches = dict(_build.launches)
    direct_one, direct_three = service.edit(painted[0])[0], service.edit(painted[:3])[0]
    service.close()
    checks = {
        "healthz": info.get("status") == "ok" and info.get("compute_dtype") == "bfloat16",
        "one": one.shape == (size, size) and bool(np.abs(one - direct_one).max() <= 1e-6),
        "three": three.shape == (3, size, size)
        and bool(np.abs(three - direct_three).max() <= 1e-6),
        "png": png[:8] == PNG_SIGNATURE,
    }
    emit({"phase": "serve_runtime", "part": "http", "device": service.device,
          "compute_dtype": service.compute_dtype, "requests": calls, "checks": checks,
          "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if cuda else None})
    if not all(checks.values()):
        raise RuntimeError(f"HTTP service: {checks}")
    if cuda and not launches.get("conv3x3_packed"):
        raise RuntimeError("the HTTP service's bf16 decode launched no conv3x3_packed")


def serve_watch_part(device, model, painted, workdir, *, poll_seconds=60.0):
    """(c) `run_recon.serve` (bf16, inotify) on a NIfTI map in `workdir`,
    three passes; an editor thread writes the next map 1.2 s after each
    recon appears (names carry second-granularity timestamps), and a third
    write wakes the loop's last wait. Raises unless 3 recon and 3 label PNGs
    appear within one poll timeout."""
    import io
    import threading

    import torch

    from medical_image_editing_tpu_torch.cli.run_recon import serve
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.fswatch import FileWatcher

    cuda = torch.device(device).type == "cuda"
    cfg = lung_config(model)
    cfg.compute_dtype = "bfloat16"
    workdir = Path(workdir)
    cfg.edited_file_path = str(workdir / "label_edit.nii.gz")
    cfg.save_dir_path = str(workdir / "inference")

    def write(m):
        nifti.save(nifti.to_nifti_array(m), cfg.edited_file_path, dtype=np.int32)

    def count(prefix):
        out = Path(cfg.save_dir_path)
        return sum(f.startswith(prefix) for f in os.listdir(out)) if out.is_dir() else 0

    write(painted[0])
    with FileWatcher(cfg.edited_file_path) as watcher:
        inotify = watcher.active
    stop = threading.Event()

    def editor():
        for k in (1, 2, 3):
            while count("recon_") < k and not stop.is_set():
                time.sleep(0.02)
            if stop.is_set():
                return
            time.sleep(1.2)
            write(painted[k % len(painted)])

    thread = threading.Thread(target=editor, daemon=True)
    log = io.StringIO()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    thread.start()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            serve(cfg, poll_seconds=poll_seconds, max_iters=3, watch="inotify", device=device)
    finally:
        stop.set()
        thread.join(timeout=30)
    elapsed = time.perf_counter() - t0
    recons, labels = count("recon_"), count("label_")
    emit({"phase": "serve_runtime", "part": "watch", "inotify_active": inotify,
          "elapsed_s": elapsed, "poll_seconds": poll_seconds, "recon_pngs": recons,
          "label_pngs": labels, "processed": log.getvalue().count("Processing..."),
          "launches": dict(_build.launches),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if cuda else None})
    if recons < 3 or labels < 3 or elapsed >= poll_seconds:
        raise RuntimeError(f"file-watching loop: {recons} recon and {labels} label PNGs "
                           f"in {elapsed:.1f} s; its log:\n{log.getvalue()}")


def kernel_breakdown(wall, kernels, top=8):
    """Busy and idle share of a profiled window, the hand-written kernels'
    device time, and the top kernels by device time."""
    busy = sum(device_us(e) for e in kernels) / 1e6
    ordered = sorted(kernels, key=device_us, reverse=True)
    return {
        "wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "vq_fused_device_s": sum(device_us(e) for e in kernels if "vq_" in e.key) / 1e6,
        "conv3x3_packed_device_s": sum(
            device_us(e) for e in kernels
            if any(sym in e.key for sym, _ in CONV_PATHS.values())) / 1e6,
        "top": [{"kernel": e.key[:90], "count": e.count, "device_s": device_us(e) / 1e6}
                for e in ordered[:top]],
    }


def routed_convs(module, x):
    """How many convolutions a forward of `module` on x sends to the packed
    kernel (`Conv.routes_to_kernel`), counted on the meta device in eval
    mode (which routes as training does, and takes no DropBlock draws)."""
    import torch

    from medical_image_editing_tpu_torch.models.blocks import Conv

    count = [0]

    def hook(m, args):
        count[0] += int(m.routes_to_kernel(args[0]))

    meta = copy.deepcopy(module).to("meta").eval()
    handles = [m.register_forward_pre_hook(hook) for m in meta.modules()
               if isinstance(m, Conv)]
    with torch.no_grad():
        meta(x.to("meta"))
    for h in handles:
        h.remove()
    return count[0]


def train_models(model, dtype, device, seed):
    """Encoder and decoder at `model` widths with compute dtype `dtype`,
    seeded weights, on `device`."""
    import torch

    from medical_image_editing_tpu_torch.models import UNetDecoder
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ

    enc = EncoderWithVQ(int(model.in_channels), tuple(model.enc_filters),
                        int(model.dict_size), momentum=float(model.momentum),
                        knn_backend=str(model.knn_backend), dtype=dtype)
    dec = UNetDecoder(enc.emb_dim, int(model.in_channels), tuple(model.dec_filters),
                      dropped_skip_layers=tuple(model.dropped_skip_layers or ()),
                      use_pixel_shuffle=bool(model.use_pixel_shuffle), dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    return seeded_init(enc, gen).to(device), seeded_init(dec, gen).to(device)


def train_state(cfg, enc, dec, device, seed):
    from medical_image_editing_tpu_torch.train import state as tstate

    return tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim),
        seed=seed, device=device)


def train_step_fn(cfg, enc, dec, dtype, device):
    from medical_image_editing_tpu_torch.train.first_stage import (
        loss_config_from_json,
        make_first_stage_step,
    )

    return make_first_stage_step(enc, dec, loss_cfg=loss_config_from_json(cfg.loss),
                                 aug_cfg=cfg.augmentation,
                                 dict_size=int(cfg.model.vqmodel.dict_size),
                                 compute_dtype=dtype, device=device)


def train_phase(device, cfg, *, size=256, batch=8, steps=5, seed=0):
    """The first-stage step at `cfg`'s model widths and compute dtype with
    the packed conv route: codebook init, then `steps` steps. Returns the
    launch counts of the run and (step, state, images, warm step times) for
    profiling."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    model = cfg.model.vqmodel
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(model.compute_dtype or "float32")]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    enc, dec = train_models(model, dtype, device, seed)
    state = train_state(cfg, enc, dec, device, seed)
    step = train_step_fn(cfg, enc, dec, dtype, device)
    images = make_slices(np.random.default_rng(seed), batch, size)
    n_enc = routed_convs(enc, torch.zeros(1, int(model.in_channels), size, size))
    n_dec = routed_convs(dec, torch.zeros(1, enc.emb_dim, size, size))
    # each step: both views through encoder and decoder, and the input
    # gradient of every routed conv (its input is an activation)
    want = {"conv3x3_packed": n_enc + steps * 4 * (n_enc + n_dec),
            "vq_fused": 2 * steps if str(model.knn_backend) in ("pallas", "faiss") else 0}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = [p.detach().clone() for p in (next(enc.parameters()), next(dec.parameters()))]

    _build.launches.clear()
    # -- main path: codebook init, then the steps
    t0 = time.perf_counter()
    init_codebook_step(enc)(state, images)
    sync()
    init_s = time.perf_counter() - t0
    vq_init = state.vq.embed.clone()
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, images)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)

    finite = all(np.isfinite(v) for m in losses for v in m.values())
    moved = [not torch.equal(a, p.detach()) for a, p in
             zip(before, (next(enc.parameters()), next(dec.parameters())))]
    vq_moved = not torch.equal(vq_init, state.vq.embed)
    rec = {
        "phase": "train", "device": str(device), "size": size, "batch": batch,
        "steps": steps, "compute_dtype": str(dtype).split(".")[-1],
        "enc_filters": list(model.enc_filters), "dec_filters": list(model.dec_filters),
        "dict_size": int(model.dict_size), "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want if cuda else {},
        "init_codebook_s": init_s, "step_s": step_s, "losses_first": losses[0],
        "losses_last": losses[-1],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "card": nvidia_smi() if cuda else None,
    }
    emit(rec)
    if not finite or not all(moved) or not vq_moved:
        raise RuntimeError(f"train step: finite {finite}, params moved {moved}, "
                           f"codebook moved {vq_moved}")
    if cuda and {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"kernel launches {launches}, derived {want}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")
    return launches, SimpleNamespace(step=step, state=state, images=images,
                                     warm_s=step_s[1:])


def train_profile_phase(trained):
    """Device time by kernel of one warm training step. The profiler's own
    host work stretches the window's wall time, so the idle share is also
    given against the fastest unprofiled warm step."""
    wall, kernels = profile_window(lambda: trained.step(trained.state, trained.images))
    rec = {"phase": "profile", "step": "train_step", **kernel_breakdown(wall, kernels, 12)}
    rec["conv3x3_packed_share_of_busy"] = (rec["conv3x3_packed_device_s"]
                                           / rec["device_busy_s"])
    rec["warm_step_s"] = min(trained.warm_s)
    rec["device_idle_share_of_warm_step"] = 1.0 - rec["device_busy_s"] / rec["warm_step_s"]
    emit(rec)


def train_reference_phase(cfg, *, size=64, batch=2, seed=1):
    """One step on the card vs the same step on the port's CPU path, at the
    model's widths in f32 (TF32 off) on a small input, packed route: the
    same weights, codebook (k-means on the CPU) and draws on both."""
    import torch

    from medical_image_editing_tpu_torch.models.unet_encoder import encode_quantize
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    tf32_off()  # held to the CPU at full f32

    model = cfg.model.vqmodel
    images = make_slices(np.random.default_rng(seed), batch, size)
    gen = torch.Generator().manual_seed(seed)
    draws = [sample_view_draws(gen, cfg.augmentation, batch, size, size) for _ in range(2)]
    enc, dec = train_models(model, torch.float32, "cpu", seed)
    init_codebook_step(enc)(train_state(cfg, enc, dec, "cpu", seed), images)
    start = (copy.deepcopy(enc.state_dict()), copy.deepcopy(dec.state_dict()))
    out = {}
    for device in ("cpu", "cuda"):
        enc, dec = train_models(model, torch.float32, device, seed)
        enc.load_state_dict(start[0])
        dec.load_state_dict(start[1])
        state = train_state(cfg, enc, dec, device, seed)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device)
            feats = enc.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            _, _, ids, _ = encode_quantize(enc, state.vq, x, train=False,
                                           backend=enc.knn_backend)
        on = [{part: [None if d is None else {k: None if v is None else v.to(device)
                                              for k, v in d.items()} for d in ds]
               for part, ds in view.items()} for view in draws]
        _, metrics = train_step_fn(cfg, enc, dec, torch.float32, device)(
            state, images, draws=on)
        out[device] = (feats.cpu(), ids.cpu(), {k: float(v) for k, v in metrics.items()})
    feats, ids_cpu, m_cpu = out["cpu"]
    embed = start[0]["vq.embed"]
    top2 = vq_scores(embed, feats.reshape(-1, feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(ids_cpu.shape)
    id_mismatch = int(((out["cuda"][1] != ids_cpu) & clear).sum())
    loss_err = {k: abs(out["cuda"][2][k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items()}
    # an id that flips at a near-tie inside the step moves the cross loss
    # (and the total) by ~1/(pixels of its code) ≈ 1e-3; the distance loss
    # takes the square root of a rounding residue on its diagonal
    rtol = {k: 1e-2 if k in ("cross", "total", "dist") else 1e-3 for k in loss_err}
    rec = {"phase": "train_reference", "size": size, "batch": batch,
           "id_mismatches_clear": id_mismatch, "clear_share": float(clear.float().mean()),
           "loss_rel_err": loss_err, "losses_cpu": m_cpu, "losses_card": out["cuda"][2],
           "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; "
                        f"losses rtol {rtol}"}
    emit(rec)
    if id_mismatch or any(loss_err[k] > rtol[k] for k in loss_err):
        raise RuntimeError(f"card vs CPU training step: {id_mismatch} clear id mismatches, "
                           f"loss errors {loss_err}")


def write_lung_tree(root, rng, *, patients, slices, size):
    """`patients` × `slices` lung slices (`make_slices`, mapped from the
    config's [-1, 1] window back to HU) as `root/patNN/ct_img_SSSS.npy`, the
    names `NCCLungDataset` walks and parses."""
    for p in range(patients):
        d = Path(root) / f"pat{p:02d}"
        d.mkdir(parents=True)
        hu = (make_slices(rng, slices, size)[..., 0] / 2 + 0.5) * 4096 - 2048
        for s in range(slices):
            np.save(d / f"ct_img_{s:04d}.npy", hu[s].astype(np.float32))


@contextlib.contextmanager
def captured_trainers():
    """The trainers `run_vqwnet.main` builds inside the block, in order, as
    (trainer, steps): each training step's call appends (host clock, its
    image batch) to steps."""
    from medical_image_editing_tpu_torch.cli import run_vqwnet

    build, seen = run_vqwnet.build_trainer, []

    def capture(*args, **kw):
        trainer, logger = build(*args, **kw)
        steps, step = [], trainer.train_step

        def recorded(state, image, draws=None):
            steps.append((time.perf_counter(), image))
            return step(state, image, draws)

        trainer.train_step = recorded
        seen.append((trainer, steps))
        return trainer, logger

    run_vqwnet.build_trainer = capture
    try:
        yield seen
    finally:
        run_vqwnet.build_trainer = build


def run_cli(work, base, name, argv, cuda, **changes):
    """`run_vqwnet.main` in-process on the config dict `base` with
    `changes` ({section: {key: value}}) merged in and `save.save_dir` =
    work/name, under MEDIMG_CONV_PRECISION=ieee (the CLI sets the
    precision, and every run here is held to another or to the CPU at full
    f32), TF32 checked off after it returns; returns the study's run
    directory."""
    from medical_image_editing_tpu_torch.cli import run_vqwnet

    cfg = copy.deepcopy(base)
    cfg["save"]["save_dir"] = str(work / name)
    for section, values in changes.items():
        cfg[section].update(values)
    path = work / f"{name}.json"
    path.write_text(json.dumps(cfg))
    argv = ["-c", str(path), *argv] + ([] if cuda else ["--device", "cpu"])
    with conv_precision("ieee"):
        if run_vqwnet.main(argv) != 0:
            raise RuntimeError(f"run_vqwnet {argv} failed")
        tf32_off()
    return work / name / str(base["save"]["study_name"])


def trace_idle_share(path):
    """Device busy time and idle share of a Chrome trace written by
    torch.profiler: kernel, copy and memset time over the span of all its
    events."""
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e6
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in device) / 1e6
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    return {"window_s": span, "device_busy_s": busy,
            "device_idle_share": None if not busy else 1.0 - busy / span,
            "device_ops": len(device), "cuda_runtime_calls": len(runtime),
            "cuda_runtime_s": sum(e["dur"] for e in runtime) / 1e6}


def trainer_phase(device, workdir, *, size=256, patients=2, slices=20, seed=0,
                  overrides=None, bare_step_s=None):
    """The first-stage training run through `run_vqwnet.main`, as a user
    runs it: the lung config unchanged in widths and losses (`overrides`
    shrinks it for a CPU rehearsal) on a seeded slice tree of `patients` ×
    `slices` (5 steps an epoch at the config's batch 8), 2 epochs,
    `save_every_n_steps: 3`. Run A: 10 steps (steps 7-9 under the
    profiler). Run B: `--max-steps 7`, then a resume to 10, held to A: the
    same image batches in the same order, the same counters, and the same
    final parameters and codebook bit for bit (measured so on an H100 as on
    the CPU). Then `-m test` (a finite result.csv), the "inference" export
    (label maps), and one painted export decoded through `edit_study`. The
    kernel launches of the whole path are held to the counts derived from
    the model. Last, off the counted path, a planted fault: B's step-7 save
    with both Adam states dropped (moments and step counters), resumed to
    10; its gap to A, which must not be 0, is how far the check's limit
    sits below a faulty resume. Returns the launches."""
    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import edit_study
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_file,
        restore_state,
    )
    from medical_image_editing_tpu_torch.utils.config import to_config

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir)
    rng = np.random.default_rng(seed)
    write_lung_tree(work / "data", rng, patients=patients, slices=slices, size=size)
    base = json.loads(MODEL_CONFIG.read_text())
    for section, values in (overrides or {}).items():
        node = base
        for key in section.split("."):
            node = node[key]
        node.update(values)
    base["dataset"]["root_dir_path"] = str(work / "data")
    base["run"]["n_epochs"] = 2
    base["save"]["save_every_n_steps"] = 3
    model, ds = base["model"]["vqmodel"], base["dataset"]
    batch = int(ds["batch_size"])
    steps_per_epoch = patients * slices // batch
    total_steps = 2 * steps_per_epoch
    eval_batches = -(-patients * slices // batch)

    def run(name, argv, **changes):
        return run_cli(work, base, name, argv, cuda, **changes)

    enc_in = torch.zeros(1, int(model["in_channels"]), size, size)
    dtype = {"bfloat16": torch.bfloat16}.get(model.get("compute_dtype"), torch.float32)
    shapes = Trainer(to_config(base), device="cpu").init_state()
    n_enc = routed_convs(shapes.encoder, enc_in)
    n_dec = routed_convs(shapes.decoder, torch.zeros(1, int(model["enc_filters"][0]), size, size))
    del shapes
    vq_on = cuda and str(model["knn_backend"]) in ("pallas", "faiss")
    # runs A and B (B in two parts) take 2 × total_steps steps: each sends
    # both views through encoder and decoder, then every routed conv's input
    # gradient, and assigns twice; k-means (A, and B's first part): one
    # encoder forward; eval forwards (encoder, decoder, one assignment):
    # validation on 2 batches at each of the 4 epoch ends, the test and the
    # export over every test batch; the edit: one decoder forward
    evals = 4 * 2 + 2 * eval_batches
    want = {"conv3x3_packed": (2 * n_enc + 2 * total_steps * 4 * (n_enc + n_dec)
                               + evals * (n_enc + n_dec) + n_dec),
            "vq_fused": 2 * total_steps * 2 + evals}
    if not cuda:
        want = {}
    elif not vq_on:
        want["vq_fused"] = 0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    # -- main path: train A (profiled), train B + resume, test, export, edit
    t0 = time.perf_counter()
    with captured_trainers() as trainers:
        run_a = run("A", ["-m", "train"],
                       run={"profile_dir": str(work / "trace"), "profile_start_step": 7,
                            "profile_num_steps": 2})
        run_b = run("B", ["-m", "train", "--max-steps", "7"])
        run("B", ["-m", "train"],
                        run={"resume_checkpoint": str(run_b / "version_0" / "ckpt")})
        run_t = run("T", ["-m", "test"],
                       run={"resume_checkpoint": str(run_a / "version_0" / "ckpt")})
        run_i = run("I", ["-m", "test"],
                       run={"training_mode": "inference",
                            "resume_checkpoint": str(run_a / "version_0" / "ckpt")})
        (trainer_a, steps_a), (_, steps_b), (_, steps_b2), (trainer_t, _) = trainers[:4]
        # the painted export, decoded with the trained decoder and codebook
        state = restore_state(str(run_a / "version_0" / "ckpt"), trainer_t.init_state())
        labels = sorted((run_i / "pat00").glob("label_*.nii.gz"))
        ids = nifti.load(str(labels[0])).astype(np.int32)
        painted_dir, edited_dir = work / "painted", work / "edited"
        painted_dir.mkdir()
        nifti.save(paint(ids[None], rng, int(model["dict_size"]))[0],
                   str(painted_dir / labels[0].name), dtype=np.int32)
        edited = edit_study(state.decoder, state.vq, str(painted_dir), str(edited_dir),
                            batch_size=1, is_lung=True,
                            dataset_window=(ds["window_width"], ds["window_center"],
                                            ds["window_scale"]), device=device)
        if cuda:
            torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    # -- B against A: the batch stream, the counters, the final state
    steps_resumed = steps_b + steps_b2
    same_stream = len(steps_a) == len(steps_resumed) == total_steps and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(steps_a, steps_resumed))
    final_a = load_state_file(str(run_a / "version_0" / "ckpt" / "ckpt-epoch=0001"))
    final_b = load_state_file(str(run_b / "version_1" / "ckpt" / "ckpt-epoch=0001"))
    params = {part: {k for k, _ in getattr(trainer_a.init_state(), part).named_parameters()}
              for part in ("encoder", "decoder")}

    def state_gap(x, y):
        """The largest parameter difference of each module; the codebook's
        relative difference."""
        gap = {part: max(float((x[part][k] - y[part][k]).abs().max()) for k in params[part])
               for part in params}
        ex, ey = x["encoder"]["vq.embed"], y["encoder"]["vq.embed"]
        return {**gap, "codebook_rel": float((ex - ey).norm() / ex.norm())}

    gap = state_gap(final_a, final_b)
    counters = {"A": (final_a["step"], final_a["epoch"]), "B": (final_b["step"], final_b["epoch"])}

    # -- timings: the fit loop's warm steps in runs A and B, from one step's
    # call to the next (no save, validation, epoch end or profiler inside
    # the period), the native loader, one save
    warm = []
    for steps, first in ((steps_a, 1), (steps_b, 1), (steps_b2, 8)):
        t = dict(zip(range(first, first + len(steps)), (c for c, _ in steps)))
        warm += [t[k] - t[k - 1] for k in sorted(t) if k - 1 in t and (k - 1) % 3
                 and (k - 1) % steps_per_epoch and not (steps is steps_a and 7 <= k <= 10)]
    trace = trace_idle_share(work / "trace" / "trace.json")
    loader = trainer_a.dataloader("train")
    numpy_loader = trainer_a.dataloader("train")
    numpy_loader.native = False
    per_batch = {"native": [], "numpy": []}
    for name, ld in 2 * (("native", loader), ("numpy", numpy_loader)):  # in turns
        ld.num_workers = 0
        t1 = time.perf_counter()
        n = sum(1 for _ in ld.epoch_iterator(0))
        per_batch[name].append((time.perf_counter() - t1) / n)
    t1 = time.perf_counter()
    saved = CheckpointManager(str(work / "save_probe")).save(state, 0)
    save_s = time.perf_counter() - t1
    save_bytes = os.path.getsize(os.path.join(saved, "state.pt"))

    result = list(csv.reader(open(run_t / "version_0" / "result.csv")))
    result_finite = len(result) == 2 and all(np.isfinite(float(v)) for v in result[1][1:])
    label_ids = nifti.load(str(labels[0]))
    out = nifti.load(str(edited_dir / edited[0]))
    ckpts = {k: sorted(os.listdir(p / "ckpt")) for k, p in
             (("A", run_a / "version_0"), ("B", run_b / "version_0"),
              ("B_resumed", run_b / "version_1"))}
    n_ok = len(list(run_i.rglob("label_*.nii.gz"))) == patients * slices

    # -- the planted fault, off the counted path
    faulty = load_state_file(str(run_b / "version_0" / "ckpt" / "ckpt-epoch=0001-step=00000007"))
    faulty["enc_opt"]["state"], faulty["dec_opt"]["state"] = {}, {}
    planted = work / "planted" / "ckpt-epoch=0001-step=00000007"
    planted.mkdir(parents=True)
    torch.save(faulty, planted / "state.pt")
    run_c = run("C", ["-m", "train"], run={"resume_checkpoint": str(planted)})
    planted_gap = state_gap(final_a, load_state_file(
        str(run_c / "version_0" / "ckpt" / "ckpt-epoch=0001")))
    lr = float(base["enc_optim"]["lr"])
    rec = {
        "phase": "trainer", "device": str(device), "size": size, "batch": batch,
        "steps": total_steps, "steps_per_epoch": steps_per_epoch,
        "compute_dtype": str(dtype).split(".")[-1],
        "enc_filters": list(model["enc_filters"]), "dec_filters": list(model["dec_filters"]),
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want, "path_s": path_s,
        "native_loader": loader.native, "loader_batch_s": per_batch,
        "fit_step_s": warm, "fit_step_s_median": float(np.median(warm)),
        "bare_step_s_median": None if not bare_step_s else float(np.median(bare_step_s)),
        "profiled_steps": [7, 8, 9], **{f"trace_{k}": v for k, v in trace.items()},
        "checkpoints_after_retention": ckpts, "save_s": save_s, "save_bytes": save_bytes,
        "same_batch_stream": same_stream, "counters": counters, "resume_gap": gap,
        "resume_gap_limit": 0.0, "planted_fault_gap": planted_gap,
        "planted_fault_param_gap_lr": max(planted_gap["encoder"], planted_gap["decoder"]) / lr,
        "result_csv": result,
        "label_maps": n_ok, "label_range": [int(label_ids.min()), int(label_ids.max())],
        "edited_range": [float(out.min()), float(out.max())],
        "max_memory_allocated_bytes": peak, "card": nvidia_smi() if cuda else None,
    }
    emit(rec)
    checks = {
        "native_loader": loader.native, "same_batch_stream": same_stream,
        "counters": counters["A"] == counters["B"] == (total_steps, 2),
        "resume_gap": all(v == 0.0 for v in gap.values()),
        "planted_fault_caught": max(planted_gap["encoder"], planted_gap["decoder"]) > 0.0,
        "retention": ckpts == {"A": ["ckpt-epoch=0000", "ckpt-epoch=0001"],
                               "B": ["ckpt-epoch=0000", "ckpt-epoch=0001-step=00000007"],
                               "B_resumed": ["ckpt-epoch=0001"]},
        "result_csv": result_finite, "label_maps": n_ok,
        "labels_in_codebook": 1 <= label_ids.min() and label_ids.max() <= model["dict_size"],
        "edited": bool(np.isfinite(out).all() and out.min() >= -1.0 and out.max() <= 1.0),
        "validation_grids": (run_a / "version_0" / "val_0001_1.png").exists(),
        "launches": ({k: launches.get(k, 0) for k in want} == want) if cuda
        else launches == {},
    }
    if not all(checks.values()):
        raise RuntimeError(f"trainer phase: {checks}")
    return launches


def second_config(overrides=None, path=SECOND_CONFIG, **sections):
    """The lung second-stage config (or the one at `path`) as a dict,
    `overrides` ({"a.b": {...}}) and `sections` ({"run": {...}}) merged in;
    the staged first stage cleared unless given."""
    base = json.loads(Path(path).read_text())
    base["run"]["first_stage_ckpt_path"] = None
    for section, values in {**(overrides or {}), **sections}.items():
        node = base
        for key in section.split("."):
            node = node[key]
        node.update(values)
    return base


def second_state(cfg, device, seed, multi_window=False):
    """The trainer's fresh state for `cfg` (a dict; the multi-window
    trainer's with `multi_window`): encoder and decoder seeded as
    `seeded_init` fills them, the discriminator (in the GAN modes) as the
    JAX module initialises, the Adams, the generator."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    trainer = Trainer(to_config(cfg), device=device, seed=seed, use_multi_window=multi_window)
    return trainer, trainer.init_state()


def second_step_fn(trainer, state, device):
    from medical_image_editing_tpu_torch.train.second_stage import make_second_stage_step

    return make_second_stage_step(state.encoder, state.decoder, state.discriminator,
                                  loss_cfg=trainer.second_cfg, dis_type=trainer.dis_type,
                                  device=device)


def fork_state(cfg, state, device):
    """A copy of a second-stage state (modules, Adam states; the generator
    fresh): a step on it leaves `state` as it was."""
    from medical_image_editing_tpu_torch.train import state as tstate
    from medical_image_editing_tpu_torch.utils.config import to_config

    c = to_config(cfg)
    enc, dec, dis = (copy.deepcopy(m) for m in (state.encoder, state.decoder,
                                                 state.discriminator))
    opts = []
    for module, section, src in ((enc, c.enc_optim, state.enc_opt),
                                 (dec, c.dec_optim, state.dec_opt),
                                 (dis, c.dis_optim, state.dis_opt)):
        opt = tstate.make_optimizer_from_config(module.parameters(), section)
        opt.load_state_dict(copy.deepcopy(src.state_dict()))
        opts.append(opt)
    return tstate.create_train_state(enc, dec, opts[0], opts[1], device=device,
                                     discriminator=dis, dis_opt=opts[2])


def dis_work(dis, image, recon, draws, opt=None):
    """The discriminator's work in one second-stage step, alone (NCHW
    inputs): the generator pass's forward on the reconstruction and its
    input gradient, the forward on the real batch for the feature targets,
    then per draw the real, fake and CutMix forwards, one backward into the
    parameters and (with `opt`) one Adam step."""
    import torch

    from medical_image_editing_tpu_torch.ops.cutmix import cutmix_mask, mask_src_tgt

    params = list(dis.parameters())
    for p in params:
        p.requires_grad_(False)
    x = recon.detach().requires_grad_(True)
    f_map, f_bottle, f_feats = dis(x)
    (-(f_map.mean() + f_bottle.mean()) + sum(t.pow(2).mean() for t in f_feats)).backward()
    with torch.no_grad():
        dis(image)
    for p in params:
        p.requires_grad_(True)
    h, w = image.shape[-2:]
    for box, _ in draws:
        m = cutmix_mask(box, h, w).to(image.device)
        r_map, r_bottle, _ = dis(image)
        f_map, f_bottle, _ = dis(recon)
        c_map, c_bottle, _ = dis(mask_src_tgt(image, recon, m))
        loss = (torch.relu(1 - r_map).mean() + torch.relu(1 + f_map).mean()
                + torch.relu(1 - r_bottle).mean() + torch.relu(1 + f_bottle).mean()
                + torch.relu(1 + c_bottle).mean() + torch.relu(1 - c_map).mean()
                + (c_map - mask_src_tgt(r_map, f_map, m)).pow(2).mean())
        if opt is not None:
            opt.zero_grad()
        loss.backward()
        if opt is not None:
            opt.step()


def dis_step_flops(dis, batch, size, n_inner):
    """Operations of the discriminator's work in one step
    (`dis_work`), counted by `torch.utils.flop_counter` on the meta device
    at the step's shapes: (total, one forward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    meta = copy.deepcopy(dis).to("meta")
    x = torch.zeros(batch, 1, size, size, device="meta")
    draws = sample_cutmix_draws(torch.Generator().manual_seed(0), n_inner, size, size)
    draws = [(tuple(tuple(v.to("meta") for v in p) for p in box), inv) for box, inv in draws]
    with FlopCounterMode(display=False) as fc:
        dis_work(meta, x, x.clone(), draws)
    total = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        meta(x)
    return total, fc.get_total_flops()


def second_stage_phase(device, workdir, *, size=256, batch=8, steps=5, seed=0, overrides=None,
                       ref_size=64):
    """The second (adversarial) stage at the lung second-stage config's
    widths (`overrides` shrinks it for a CPU rehearsal): (a) the bare step,
    one step held to the CPU path on a small input, (b) the run through
    `run_vqwnet.main` staged from the trainer phase's run-A first stage in
    `workdir`. Returns the launches of (a) and (b)."""
    launches = second_stage_step_part(device, overrides, size=size, batch=batch, steps=steps,
                                      seed=seed)
    second_stage_reference_part(overrides, size=ref_size, seed=seed + 1, card=device)
    run = second_stage_run_part(device, workdir, overrides, seed=seed)
    return {k: launches.get(k, 0) + run.get(k, 0) for k in set(launches) | set(run)}


def second_stage_step_part(device, overrides, *, size, batch, steps, seed):
    """(a) `make_second_stage_step` from seeded weights (codebook k-means
    on the batch first, as the trainer's gate), `steps` steps with the
    packed conv route, launches held to the derived counts; on the card:
    one profiled warm step (busy, idle share, top kernels), the
    discriminator's work alone under the profiler (its share of busy and
    its achieved f32 rate against the operations counted from the model),
    peak memory, and one warm step with cuDNN's TF32 on (PyTorch's default
    for convolutions), its time and loss gap beside the f32 step."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    cfg = second_config(overrides)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    trainer, state = second_state(cfg, device, seed)
    model = cfg["model"]["vqmodel"]
    n_inner = trainer.second_cfg.n_inner_loops
    step = second_step_fn(trainer, state, device)
    images = make_slices(np.random.default_rng(seed), batch, size)
    init_codebook_step(state.encoder)(state, images)
    n_enc = routed_convs(state.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(state.decoder,
                         torch.zeros(1, int(model["enc_filters"][0]), size, size))
    # each step: the frozen encoder forward (no gradient), the decoder
    # forward and every routed conv's input gradient; one assignment
    vq_on = str(model["knn_backend"]) in ("pallas", "faiss")
    want = {"conv3x3_packed": steps * (n_enc + 2 * n_dec), "vq_fused": steps if vq_on else 0}
    before = {m: [p.detach().clone() for p in getattr(state, m).parameters()][:1]
              for m in ("encoder", "decoder", "discriminator")}
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _build.launches.clear()
    # -- main path: the steps
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, images)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)

    moved = {m: not torch.equal(before[m][0], next(getattr(state, m).parameters()).detach())
             for m in before}
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    flops, fwd_flops = dis_step_flops(state.discriminator, batch, size, n_inner)
    rec = {
        "phase": "second_stage", "part": "step", "device": str(device), "size": size,
        "batch": batch, "steps": steps, "n_inner_loops": n_inner,
        "compute_dtype": str(model["compute_dtype"]), "dis": cfg["model"]["dis"],
        "dis_parameters": sum(p.numel() for p in state.discriminator.parameters()),
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want if cuda else {},
        "step_s": step_s, "warm_step_s_median": float(np.median(step_s[1:])),
        "losses_first": losses[0], "losses_last": losses[-1],
        "dis_forward_flop": fwd_flops, "dis_step_flop": flops,
        "dis_step_forward_equivalents": flops / fwd_flops,
    }

    def measure(fn):
        """(wall, CUDA kernel events) of one call under the profiler on the
        card; elsewhere the call alone."""
        if cuda:
            return profile_window(fn)
        fn()
        return None, []

    if cuda:
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        # one warm step under the profiler
        wall, kernels = profile_window(lambda: step(state, images))
        rec["profile"] = kernel_breakdown(wall, kernels, 12)
        busy = rec["profile"]["device_busy_s"]
        rec["device_idle_share_of_warm_step"] = 1.0 - busy / rec["warm_step_s_median"]
    # the discriminator's work alone, on a copy, with the step's draws
    dis = copy.deepcopy(state.discriminator)
    dis_opt = torch.optim.Adam(dis.parameters(), lr=4e-4, betas=(0.5, 0.999))
    x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
    recon = torch.tanh(x + 0.1 * torch.randn_like(x))
    draws = sample_cutmix_draws(torch.Generator(device=device).manual_seed(seed), n_inner,
                                size, size)
    dis_work(dis, x, recon, draws, dis_opt)
    dwall, dkernels = measure(lambda: dis_work(dis, x, recon, draws, dis_opt))
    del dis, dis_opt
    if cuda:
        dbusy = sum(device_us(e) for e in dkernels) / 1e6
        rec.update({
            "dis_work_device_busy_s": dbusy, "dis_share_of_step_busy": dbusy / busy,
            "dis_work_top": kernel_breakdown(dwall, dkernels, 6)["top"],
            "dis_achieved_f32_flop_per_s": flops / dbusy,
            "dis_share_of_f32_peak": flops / dbusy / PEAK_F32_FLOP_PER_S,
            "dis_f32_floor_s": flops / PEAK_F32_FLOP_PER_S,
        })
    # TF32 for cuDNN's convolutions (information: the trainer leaves
    # precision to PyTorch's settings): one step from the same state and
    # draws in f32 and in TF32, then a warm TF32 step timed
    draws = sample_cutmix_draws(torch.Generator(device=device).manual_seed(seed + 1),
                                n_inner, size, size)
    f32_state, tf32_state = fork_state(cfg, state, device), fork_state(cfg, state, device)
    _, m32 = second_step_fn(trainer, f32_state, device)(f32_state, images, draws)
    tf32_step = second_step_fn(trainer, tf32_state, device)
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, m_tf32 = tf32_step(tf32_state, images, draws)
        tf32_s = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            tf32_step(tf32_state, images, draws)
            sync()
            tf32_s.append(time.perf_counter() - t0)
        _, tkernels = measure(lambda: tf32_step(tf32_state, images, draws))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    # run to run: the same f32 step twice from one state and draws
    again = fork_state(cfg, state, device)
    second_step_fn(trainer, again, device)(again, images, draws)
    rerun = {m: max(float((p.detach() - q.detach()).abs().max()) for p, q in
                    zip(getattr(f32_state, m).parameters(), getattr(again, m).parameters()))
             for m in ("decoder", "discriminator")}
    del f32_state, tf32_state, again
    rec["f32_step_rerun_param_gap"] = rerun
    rec.update({
        "tf32_warm_step_s": tf32_s, "tf32_warm_step_s_median": float(np.median(tf32_s)),
        "tf32_device_busy_s": sum(device_us(e) for e in tkernels) / 1e6 if cuda else None,
        "tf32_loss_rel_gap": {k: abs(float(m_tf32[k]) - float(v)) / max(abs(float(v)), 1e-12)
                              for k, v in m32.items()},
    })
    rec["card"] = nvidia_smi() if cuda else None
    emit(rec)
    if not finite or not moved["decoder"] or not moved["discriminator"] or moved["encoder"]:
        raise RuntimeError(f"second-stage step: finite {finite}, moved {moved}")
    if cuda and {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"second-stage kernel launches {launches}, derived {want}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")
    return launches


def second_stage_reference_part(overrides, *, size=64, batch=2, seed=1, card="cuda"):
    """One second-stage step on the card vs the same step on the port's CPU
    path, at the config's widths in f32 (TF32 off) on a small input, packed
    route: the same weights, codebook (k-means on the CPU) and CutMix draws
    on both. Held: the ids where the top-2 score gap is clear of rounding,
    every loss (rtol 1e-3), and the gradients of decoder and discriminator
    read from Adam's first moment (relative Frobenius error), within 5× the
    card's own floor (its packed and xla conv routes against each other)
    or 1e-4. The card runs again without cuDNN, for information. `card` is
    the device held to the CPU ("cpu" rehearses the comparison)."""
    import torch

    from medical_image_editing_tpu_torch.models.unet_encoder import encode_quantize
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    tf32_off()  # held to the CPU at full f32

    cfg = second_config(overrides, **{"model.vqmodel": {"compute_dtype": "float32"}})
    images = make_slices(np.random.default_rng(seed), batch, size)
    trainer, state = second_state(cfg, "cpu", seed)
    init_codebook_step(state.encoder)(state, images)
    start = {m: copy.deepcopy(getattr(state, m).state_dict())
             for m in ("encoder", "decoder", "discriminator")}
    draws = sample_cutmix_draws(torch.Generator().manual_seed(seed),
                                trainer.second_cfg.n_inner_loops, size, size)
    out = {}
    runs = [("cpu", "cpu", "packed", True), ("card", card, "packed", True)]
    if card == "cuda":  # the card again without the conv kernel, and without cuDNN
        runs += [("card_xla", card, "xla", True), ("card_no_cudnn", card, "xla", False)]
    for name, device, route, use_cudnn in runs:
        trainer, state = second_state(cfg, device, seed)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device)
            feats = state.encoder.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            _, _, ids, _ = encode_quantize(state.encoder, state.vq, x, train=False,
                                           backend=state.encoder.knn_backend)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        prev_cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = use_cudnn
        try:
            with conv_route(route):
                _, metrics = second_step_fn(trainer, state, device)(state, images, draws=on)
        finally:
            torch.backends.cudnn.enabled = prev_cudnn
        grads = {m: torch.cat([o.state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()])
                 for m, o in (("decoder", state.dec_opt), ("discriminator", state.dis_opt))}
        out[name] = (feats.cpu(), ids.cpu(), {k: float(v) for k, v in metrics.items()}, grads)
    feats, ids_cpu, m_cpu, g_cpu = out["cpu"]
    top2 = vq_scores(start["encoder"]["vq.embed"],
                     feats.reshape(-1, feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(ids_cpu.shape)
    id_mismatch = int(((out["card"][1] != ids_cpu) & clear).sum())
    loss_err = {k: abs(out["card"][2][k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items()}
    grad_err = {m: float((out["card"][3][m] - g).norm() / g.norm()) for m, g in g_cpu.items()}
    variants = {name: {m: float((o[3][m] - g_cpu[m]).norm() / g_cpu[m].norm()) for m in g_cpu}
                for name, o in out.items() if name.startswith("card_")}
    # the card's two conv routes against each other: how far f32 rounding
    # alone moves these gradients (the decoder's is ill-conditioned at
    # these widths); the card is held to 5× that floor, or 1e-4
    floor = {m: 0.0 for m in g_cpu}
    if "card_xla" in out:
        floor = {m: float((out["card_xla"][3][m] - g).norm() / g.norm())
                 for m, g in out["card"][3].items()}
    grad_limit = {m: max(5 * f, 1e-4) for m, f in floor.items()}

    rec = {"phase": "second_stage", "part": "reference", "card": card, "size": size,
           "batch": batch,
           "id_mismatches_clear": id_mismatch, "clear_share": float(clear.float().mean()),
           "loss_rel_err": loss_err, "grad_rel_err": grad_err,
           "grad_rel_err_variants": variants, "grad_route_floor": floor,
           "grad_limit": grad_limit,
           "losses_cpu": m_cpu,
           "losses_card": out["card"][2],
           "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; losses rtol "
                        "1e-3; gradients (Adam's first moment) 5x the card's conv-route "
                        "floor or 1e-4"}
    emit(rec)
    if id_mismatch or max(loss_err.values()) > 1e-3 or any(
            grad_err[m] > grad_limit[m] for m in grad_err):
        raise RuntimeError(f"card vs CPU second-stage step: {id_mismatch} clear id "
                           f"mismatches, loss errors {loss_err}, gradient errors {grad_err}")


@contextlib.contextmanager
def captured_validation():
    """Record the largest |map| of each validation grid's discriminator
    maps (None where a grid draws zeros) written inside the block."""
    from medical_image_editing_tpu_torch.train import evaluate

    snapshot, seen = evaluate.validation_snapshot, []

    def capture(*args, dis_maps=None, **kw):
        seen.append(None if dis_maps is None else
                    [float(m.abs().max()) if np.isfinite(float(m.abs().max())) else None
                     for m in dis_maps])
        return snapshot(*args, dis_maps=dis_maps, **kw)

    evaluate.validation_snapshot = capture
    try:
        yield seen
    finally:
        evaluate.validation_snapshot = snapshot


def second_stage_run_part(device, workdir, overrides, *, seed=0):
    """(b) The second stage as a user runs it: `run_vqwnet.main` on the lung
    second-stage config (`overrides` shrinks it for a CPU rehearsal) over
    the trainer phase's slice tree, staged from its run-A first stage
    (`first_stage_ckpt_path`), 2 epochs of 5 steps, saving every 3. Run A:
    6 steps. Run B: stops at 3, resumes to 6; held to A (slice order,
    counters; parameters, Adam moments and spectral-norm vectors of decoder
    and discriminator within SECOND_RESUME_GAP_LIMIT, the codebook equal). `-m test` writes
    result.csv, the "inference" export writes label maps, one of them is
    painted and decoded through `edit_study` with the second-stage decoder.
    The validation grids must carry the discriminator's maps; launches are
    held to the derived counts. Off the counted path, a planted fault: B's
    step-3 save with the discriminator's Adam state and spectral-norm
    vectors dropped (fresh u, σ = 1), resumed to 6; its gap is printed
    beside the resume's."""
    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import edit_study
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_file,
        restore_state,
    )

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir)
    first_study = json.loads(MODEL_CONFIG.read_text())["save"]["study_name"]
    first_ckpt = work / "A" / first_study / "version_0" / "ckpt"
    base = second_config(overrides, run={"n_epochs": 2,
                                         "first_stage_ckpt_path": str(first_ckpt)},
                         save={"save_every_n_steps": 3})
    base["dataset"]["root_dir_path"] = str(work / "data")
    model, ds = base["model"]["vqmodel"], base["dataset"]
    study = base["save"]["study_name"]
    batch = int(ds["batch_size"])
    n_slices = sum(1 for _ in (work / "data").rglob("ct_img_*.npy"))
    steps_per_epoch = n_slices // batch
    eval_batches = -(-n_slices // batch)
    size = int(np.load(next((work / "data").rglob("ct_img_*.npy"))).shape[-1])
    total = 6
    if steps_per_epoch != 5:
        raise RuntimeError(f"the second-stage run needs 5 steps an epoch, has {steps_per_epoch}")

    def run(name, argv, **changes):
        return run_cli(work, base, name, argv, cuda, **changes)

    trainer, shapes = second_state(base, "cpu", seed)
    n_enc = routed_convs(shapes.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(shapes.decoder, torch.zeros(1, int(model["enc_filters"][0]), size, size))
    params = {m: {k for k, _ in getattr(shapes, m).named_parameters()}
              for m in ("decoder", "discriminator")}
    del trainer, shapes
    # runs A and B (B in two parts) take 2 × 6 steps: each the frozen
    # encoder forward, the decoder forward and every routed conv's input
    # gradient, one assignment; k-means (A, and B's first part): one
    # encoder forward; eval forwards (encoder, decoder, one assignment):
    # validation on 2 batches at the epoch-0 end of A and of B's resume,
    # the test and the export over every test batch; the edit: one decoder
    # forward
    evals = 2 * 2 + 2 * eval_batches
    want = {"conv3x3_packed": (2 * n_enc + 2 * total * (n_enc + 2 * n_dec)
                               + evals * (n_enc + n_dec) + n_dec),
            "vq_fused": 2 * total + evals}
    if not cuda:
        want = {}
    elif str(model["knn_backend"]) not in ("pallas", "faiss"):
        want["vq_fused"] = 0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    # -- main path: train A, train B + resume, test, export, edit
    t0 = time.perf_counter()
    with captured_trainers() as trainers, captured_validation() as grids:
        run_a = run("2A", ["-m", "train", "--max-steps", str(total)])
        run_b = run("2B", ["-m", "train", "--max-steps", "3"])
        run("2B", ["-m", "train", "--max-steps", str(total)],
            run={"resume_checkpoint": str(run_b / "version_0" / "ckpt")})
        run_t = run("2T", ["-m", "test"],
                    run={"resume_checkpoint": str(run_a / "version_0" / "ckpt")})
        run_i = run("2I", ["-m", "test"],
                    run={"training_mode": "inference",
                         "resume_checkpoint": str(run_a / "version_0" / "ckpt")})
        (trainer_a, steps_a), (_, steps_b), (_, steps_b2), (trainer_t, _) = trainers[:4]
        state = restore_state(str(run_a / "version_0" / "ckpt"), trainer_t.init_state())
        labels = sorted((run_i / "pat00").glob("label_*.nii.gz"))
        ids = nifti.load(str(labels[0])).astype(np.int32)
        painted_dir, edited_dir = work / "2painted", work / "2edited"
        painted_dir.mkdir()
        rng = np.random.default_rng(seed)
        nifti.save(paint(ids[None], rng, int(model["dict_size"]))[0],
                   str(painted_dir / labels[0].name), dtype=np.int32)
        edited = edit_study(state.decoder, state.vq, str(painted_dir), str(edited_dir),
                            batch_size=1, is_lung=True,
                            dataset_window=(ds["window_width"], ds["window_center"],
                                            ds["window_scale"]), device=device)
        if cuda:
            torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    # -- B against A
    steps_resumed = steps_b + steps_b2
    same_stream = len(steps_a) == len(steps_resumed) == total and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(steps_a, steps_resumed))
    last = f"ckpt-epoch=0001-step={total:08d}"
    final_a = load_state_file(str(run_a / "version_0" / "ckpt" / last))
    final_b = load_state_file(str(run_b / "version_1" / "ckpt" / last))
    first = load_state_file(CheckpointManager(str(first_ckpt)).latest_path())

    def state_gap(x, y):
        """How far state y is from state x, for the decoder and the
        discriminator: the parameters' RMS difference in learning rates and
        their largest difference, Adam's moments' relative difference (norm
        over all of them), the spectral-norm vectors' largest difference;
        and the codebook's relative difference."""
        gap = {}
        for part, opt in (("decoder", "dec_opt"), ("discriminator", "dis_opt")):
            lr = float(base[f"{opt[:3]}_optim"]["lr"])
            keys = sorted(params[part])
            d = torch.cat([(x[part][k] - y[part][k]).flatten() for k in keys])
            sx, sy = x[opt]["state"], y[opt]["state"]
            mx = torch.cat([v.flatten() for i in sorted(sx) for k, v in sx[i].items()
                            if k != "step"])
            my = torch.cat([sy[i][k].flatten() if i in sy else torch.zeros_like(v).flatten()
                            for i in sorted(sx) for k, v in sx[i].items() if k != "step"])
            sn = [float((x[part][k] - y[part][k]).abs().max()) for k in x[part]
                  if k.endswith(("u0", "sv0"))]
            gap[part] = {"params_rms_lr": float(d.pow(2).mean().sqrt()) / lr,
                         "params_max": float(d.abs().max()),
                         "moments_rel": float((mx - my).norm() / mx.norm()),
                         "sn_max": max(sn, default=0.0)}
        ex, ey = x["encoder"]["vq.embed"], y["encoder"]["vq.embed"]
        return {**gap, "codebook_rel": float((ex - ey).norm() / ex.norm())}

    gap = state_gap(final_a, final_b)
    counters = {"A": (final_a["step"], final_a["epoch"]), "B": (final_b["step"], final_b["epoch"])}
    staged_enc = first["encoder"]
    encoder_frozen = all(torch.equal(final_a["encoder"][k], v) for k, v in staged_enc.items()
                         if not k.startswith("vq."))
    codebook_moved = float((final_a["encoder"]["vq.embed"] - staged_enc["vq.embed"]).norm()
                           / staged_enc["vq.embed"].norm())
    warm = []
    for steps, first_step in ((steps_a, 1), (steps_b, 1), (steps_b2, 4)):
        t = dict(zip(range(first_step, first_step + len(steps)), (c for c, _ in steps)))
        warm += [t[k] - t[k - 1] for k in sorted(t) if k - 1 in t and (k - 1) % 3
                 and (k - 1) % steps_per_epoch]
    result = list(csv.reader(open(run_t / "version_0" / "result.csv")))
    result_finite = len(result) == 2 and all(np.isfinite(float(v)) for v in result[1][1:])
    out = nifti.load(str(edited_dir / edited[0]))
    label_ids = nifti.load(str(labels[0]))
    n_ok = len(list(run_i.rglob("label_*.nii.gz"))) == n_slices

    # -- the planted fault, off the counted path
    faulty = load_state_file(str(run_b / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003"))
    faulty["dis_opt"]["state"] = {}
    gen = torch.Generator().manual_seed(seed)
    for k, v in faulty["discriminator"].items():
        if k.endswith("u0"):
            faulty["discriminator"][k] = torch.randn(v.shape, generator=gen)
        elif k.endswith("sv0"):
            faulty["discriminator"][k] = torch.ones_like(v)
    planted = work / "2planted" / "ckpt-epoch=0000-step=00000003"
    planted.mkdir(parents=True)
    torch.save(faulty, planted / "state.pt")
    run_c = run("2C", ["-m", "train", "--max-steps", str(total)],
                run={"resume_checkpoint": str(planted)})
    planted_gap = state_gap(final_a, load_state_file(str(run_c / "version_0" / "ckpt" / last)))
    rec = {
        "phase": "second_stage", "part": "run", "device": str(device), "size": size,
        "batch": batch, "steps": total, "steps_per_epoch": steps_per_epoch,
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want, "path_s": path_s,
        "fit_step_s": warm, "fit_step_s_median": float(np.median(warm)) if warm else None,
        "same_batch_stream": same_stream, "counters": counters, "resume_gap": gap,
        "resume_gap_limit": SECOND_RESUME_GAP_LIMIT, "planted_fault_gap": planted_gap,
        "validation_grids": grids, "encoder_frozen": encoder_frozen,
        "codebook_rel_distance_from_staged": codebook_moved, "result_csv": result,
        "label_maps": n_ok, "label_range": [int(label_ids.min()), int(label_ids.max())],
        "edited_range": [float(out.min()), float(out.max())],
        "max_memory_allocated_bytes": peak, "card": nvidia_smi() if cuda else None,
    }
    emit(rec)

    def within(g):
        return all(g[part][k] <= limit for part, limits in SECOND_RESUME_GAP_LIMIT.items()
                   for k, limit in limits.items())

    checks = {
        "same_batch_stream": same_stream,
        "counters": counters["A"] == counters["B"] == (total, 1),
        "resume_gap": within(gap) and gap["codebook_rel"] == 0.0,
        "planted_fault_caught": not within(planted_gap),
        "validation_maps": len(grids) == 4 and all(g is not None and all(g) for g in grids),
        "encoder_frozen": encoder_frozen, "codebook_reclustered": codebook_moved > 0.0,
        "result_csv": result_finite, "label_maps": n_ok,
        "labels_in_codebook": 1 <= label_ids.min() and label_ids.max() <= model["dict_size"],
        "edited": bool(np.isfinite(out).all() and out.min() >= -1.0 and out.max() <= 1.0),
        "launches": ({k: launches.get(k, 0) for k in want} == want) if cuda
        else launches == {},
    }
    if not all(checks.values()):
        raise RuntimeError(f"second-stage run: {checks}")
    return launches


def mw_config(overrides=None, **sections):
    """The multi-window joint config as a dict (see `second_config`)."""
    return second_config(overrides, path=MW_CONFIG, **sections)


def stub_optimizer():
    """An optimizer that steps nothing: the discriminator's work without
    its Adam, for counting operations on the meta device."""
    return SimpleNamespace(zero_grad=lambda: None, step=lambda: None, param_groups=[])


def mw_dis_work(dis, views, draws, dataset_window, cfg, opt):
    """The discriminator's work in one joint step, alone: the generator
    pass's forwards on both views' reconstructions in the three windows and
    their input gradients (the discriminator frozen), then the
    discriminator pass (per window: real, fake and CutMix forwards of both
    views and one backward) and `opt`'s step. `views`: [(recon, clear)]
    (B,H,W,1)."""
    from medical_image_editing_tpu_torch.train import multi_window as tmw

    fns = tmw.window_fns(dataset_window)
    recon = [r.detach().requires_grad_(True) for r, _ in views]
    with tmw.frozen(dis):
        l_gen, _ = tmw.generator_terms(dis, dis, fns, [(r, t) for r, (_, t) in zip(recon, views)],
                                       False)
        l_gen.backward()
    tmw.discriminator_update(dis, dis, fns, [(r.detach(), t) for r, t in views], draws, cfg, opt,
                             True)


def mw_dis_flops(dis, batch, size, dataset_window, cfg):
    """Operations of `mw_dis_work` at the step's shapes, counted by
    `torch.utils.flop_counter` on the meta device: (total, one forward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    meta = copy.deepcopy(dis).to("meta")
    x = torch.zeros(batch, size, size, 1, device="meta")
    draws = sample_cutmix_draws(torch.Generator().manual_seed(0), 3, size, size)
    draws = [(tuple(tuple(v.to("meta") for v in p) for p in box), inv.to("meta"))
             for box, inv in draws]
    with FlopCounterMode(display=False) as fc:
        mw_dis_work(meta, [(x, x.clone()), (x.clone(), x.clone())], draws, dataset_window, cfg,
                    stub_optimizer())
    total = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        meta(x.permute(0, 3, 1, 2))
    return total, fc.get_total_flops()


def draws_to(draws, device):
    """A joint step's draws (two views' augmentation draws, the CutMix
    draws) on `device`."""
    views = [{part: [None if d is None else {k: None if v is None else v.to(device)
                                             for k, v in d.items()} for d in ds]
              for part, ds in view.items()} for view in draws[:2]]
    cut = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
           for box, inv in draws[2]]
    return (*views, cut)


def joint_draws(trainer, generator, batch, size):
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    views = [sample_view_draws(generator, trainer.aug_cfg, batch, size, size) for _ in range(2)]
    return (*views, sample_cutmix_draws(generator, 3, size, size))


def multi_window_phase(device, workdir, *, size=256, batch=8, steps=5, mode_steps=2, seed=0,
                       overrides=None, ref_size=64):
    """The multi-window trainer at the widths of
    `configs/lung_multiwindow_joint.json` (`overrides` shrinks it for a CPU
    rehearsal): (a) the bare joint step, and the multi-window first and
    second steps; (c) one joint step held to the CPU path on a small input;
    (b) the run through `run_vqwnet.main -w` over the trainer phase's tree
    in `workdir`. Returns the launches of (a) and (b)."""
    launches = multi_window_step_part(device, overrides, size=size, batch=batch, steps=steps,
                                      mode_steps=mode_steps, seed=seed)
    multi_window_reference_part(overrides, size=ref_size, seed=seed + 1, card=device)
    run = multi_window_run_part(device, workdir, overrides, seed=seed)
    return {k: launches.get(k, 0) + run.get(k, 0) for k in set(launches) | set(run)}


def multi_window_step_part(device, overrides, *, size, batch, steps, mode_steps, seed):
    """(a) The joint step (`make_joint_step` through the trainer) from seeded
    weights after the codebook k-means (the config's `use_init_embed`
    gate), `steps` steps with the packed conv route, launches held to the
    derived counts, peak memory; on the card one profiled warm step (busy,
    idle share, top kernels) and the discriminator's work alone under the
    profiler (its share of busy and its f32 rate against the operations
    counted from the model). Then `mode_steps` bare steps each of the
    multi-window first and second steps at the same widths, their launches
    held to the derived counts."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    cfg = mw_config(overrides)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    trainer, state = second_state(cfg, device, seed, multi_window=True)
    model = cfg["model"]["vqmodel"]
    images = make_slices(np.random.default_rng(seed), batch, size)
    init_codebook_step(state.encoder)(state, images)
    n_enc = routed_convs(state.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(state.decoder,
                         torch.zeros(1, int(model["enc_filters"][0]), size, size))
    vq_on = str(model["knn_backend"]) in ("pallas", "faiss")
    # a joint step: both views through encoder and decoder, every routed
    # conv's input gradient, two assignments; the discriminator's
    # convolutions are cuDNN's
    want = {"conv3x3_packed": steps * 4 * (n_enc + n_dec), "vq_fused": 2 * steps if vq_on else 0}
    before = {m: next(getattr(state, m).parameters()).detach().clone()
              for m in ("encoder", "decoder", "discriminator")}
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _build.launches.clear()
    # -- main path: the joint steps
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, images)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    moved = {m: not torch.equal(v, next(getattr(state, m).parameters()).detach())
             for m, v in before.items()}
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    dsw = trainer.dataset_window
    flops, fwd_flops = mw_dis_flops(state.discriminator, batch, size, dsw, trainer.second_cfg)
    rec = {
        "phase": "multi_window", "part": "step", "mode": "joint_step", "device": str(device),
        "size": size, "batch": batch, "steps": steps,
        "compute_dtype": str(model["compute_dtype"]), "dis": cfg["model"]["dis"],
        "use_remat": bool(cfg["run"].get("use_remat")),
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want if cuda else {},
        "step_s": step_s, "warm_step_s_median": float(np.median(step_s[1:] or step_s)),
        "losses_first": losses[0], "losses_last": losses[-1],
        "max_memory_allocated_bytes": peak,
        "dis_forward_flop": fwd_flops, "dis_step_flop": flops,
        "dis_step_forward_equivalents": flops / fwd_flops,
    }
    if cuda:
        wall, kernels = profile_window(lambda: trainer.train_step(state, images))
        rec["profile"] = kernel_breakdown(wall, kernels, 12)
        busy = rec["profile"]["device_busy_s"]
        rec["device_idle_share_of_warm_step"] = 1.0 - busy / rec["warm_step_s_median"]
        # the discriminator's work alone, on a copy, with one step's draws
        dis = copy.deepcopy(state.discriminator)
        dis_opt = torch.optim.Adam(dis.parameters(), lr=4e-4, betas=(0.5, 0.999))
        x = torch.as_tensor(images, device=device)
        views = [(torch.tanh(x + 0.1 * torch.randn_like(x)), x) for _ in range(2)]
        draws = joint_draws(trainer, torch.Generator(device=device).manual_seed(seed), batch,
                            size)[2]
        mw_dis_work(dis, views, draws, dsw, trainer.second_cfg, dis_opt)
        dwall, dkernels = profile_window(
            lambda: mw_dis_work(dis, views, draws, dsw, trainer.second_cfg, dis_opt))
        del dis, dis_opt, views
        dbusy = sum(device_us(e) for e in dkernels) / 1e6
        rec.update({
            "dis_work_device_busy_s": dbusy, "dis_share_of_step_busy": dbusy / busy,
            "dis_work_top": kernel_breakdown(dwall, dkernels, 6)["top"],
            "dis_achieved_f32_flop_per_s": flops / dbusy,
            "dis_share_of_f32_peak": flops / dbusy / PEAK_F32_FLOP_PER_S,
            "dis_f32_floor_s": flops / PEAK_F32_FLOP_PER_S,
        })
    rec["card"] = nvidia_smi() if cuda else None
    emit(rec)
    del state, trainer
    if cuda:
        torch.cuda.empty_cache()
    if not finite or not all(moved.values()):
        raise RuntimeError(f"joint step: finite {finite}, moved {moved}")
    if cuda and {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"joint step kernel launches {launches}, derived {want}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")

    # the multi-window first and second steps: each its own main path
    per_step = {"first_step": ({"conv3x3_packed": 4 * (n_enc + n_dec), "vq_fused": 2},
                               ("encoder", "decoder")),
                "second_step": ({"conv3x3_packed": n_enc + 2 * n_dec, "vq_fused": 1},
                                ("decoder", "discriminator"))}
    for mode, (per, trained) in per_step.items():
        mcfg = mw_config(overrides, run={"training_mode": mode})
        trainer, state = second_state(mcfg, device, seed, multi_window=True)
        init_codebook_step(state.encoder)(state, images)
        want_m = {k: mode_steps * v if vq_on or k != "vq_fused" else 0 for k, v in per.items()}
        before = {m: next(getattr(state, m).parameters()).detach().clone() for m in trained}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        # -- main path: the mode's steps
        step_s, losses = [], []
        for _ in range(mode_steps):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, images)
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in metrics.items()})
        mode_launches = dict(_build.launches)
        moved = {m: not torch.equal(v, next(getattr(state, m).parameters()).detach())
                 for m, v in before.items()}
        finite = all(np.isfinite(v) for m in losses for v in m.values())
        emit({"phase": "multi_window", "part": "step", "mode": mode, "device": str(device),
              "size": size, "batch": batch, "steps": mode_steps, "step_s": step_s,
              "losses_last": losses[-1], "launches": mode_launches,
              "launches_expected": want_m if cuda else {},
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if cuda else None})
        del state, trainer
        if not finite or not all(moved.values()):
            raise RuntimeError(f"multi-window {mode}: finite {finite}, moved {moved}")
        if cuda and {k: mode_launches.get(k, 0) for k in want_m} != want_m:
            raise RuntimeError(f"multi-window {mode} launches {mode_launches}, derived {want_m}")
        if not cuda and mode_launches:
            raise RuntimeError(f"CPU tensors launched kernels: {mode_launches}")
        for k, v in mode_launches.items():
            launches[k] = launches.get(k, 0) + v
    if cuda:
        torch.cuda.empty_cache()
    return launches


def multi_window_reference_part(overrides, *, size=64, batch=2, seed=1, card="cuda"):
    """One joint step on the card vs the same step on the port's CPU path,
    at the joint config's widths in f32 (TF32 off) on a small input, packed
    route: the same weights, codebook (k-means on the CPU) and draws on
    both. Held: the ids where the top-2 score gap is clear of rounding, the
    losses (rtol 1e-3; 1e-2 for the first stage's terms that an id flipped
    at a near tie inside the step moves: cross, dist, recon, freq and the
    totals), and the gradients of encoder,
    decoder and discriminator read from Adam's first moment (relative
    Frobenius error) within 5× the card's own floor (its packed and xla
    conv routes against each other) or 1e-4. `card` is the device held to
    the CPU ("cpu" rehearses the comparison)."""
    import torch

    from medical_image_editing_tpu_torch.models.unet_encoder import encode_quantize
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    tf32_off()  # held to the CPU at full f32

    cfg = mw_config(overrides, **{"model.vqmodel": {"compute_dtype": "float32"}})
    images = make_slices(np.random.default_rng(seed), batch, size)
    trainer, state = second_state(cfg, "cpu", seed, multi_window=True)
    init_codebook_step(state.encoder)(state, images)
    start = {m: copy.deepcopy(getattr(state, m).state_dict())
             for m in ("encoder", "decoder", "discriminator")}
    draws = joint_draws(trainer, torch.Generator().manual_seed(seed), batch, size)
    parts = (("encoder", "enc_opt"), ("decoder", "dec_opt"), ("discriminator", "dis_opt"))
    out = {}
    runs = [("cpu", "cpu", "packed"), ("card", card, "packed")]
    if card == "cuda":
        runs.append(("card_xla", card, "xla"))
    for name, device, route in runs:
        trainer, state = second_state(cfg, device, seed, multi_window=True)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device)
            feats = state.encoder.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            _, _, ids, _ = encode_quantize(state.encoder, state.vq, x, train=False,
                                           backend=state.encoder.knn_backend)
        with conv_route(route):
            _, metrics = trainer.train_step(state, images, draws_to(draws, device))
        grads = {m: torch.cat([getattr(state, o).state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()]) for m, o in parts}
        out[name] = (feats.cpu(), ids.cpu(), {k: float(v) for k, v in metrics.items()}, grads)
        del state
    feats, ids_cpu, m_cpu, g_cpu = out["cpu"]
    top2 = vq_scores(start["encoder"]["vq.embed"],
                     feats.reshape(-1, feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(ids_cpu.shape)
    id_mismatch = int(((out["card"][1] != ids_cpu) & clear).sum())
    loss_err = {k: abs(out["card"][2][k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items()}
    rtol = {k: 1e-2 if k in ("cross", "dist", "recon", "freq", "total", "gen_total") else 1e-3
            for k in loss_err}
    grad_err = {m: float((out["card"][3][m] - g).norm() / g.norm()) for m, g in g_cpu.items()}
    floor = {m: 0.0 for m in g_cpu}
    if "card_xla" in out:
        floor = {m: float((out["card_xla"][3][m] - g).norm() / g.norm())
                 for m, g in out["card"][3].items()}
    grad_limit = {m: max(5 * f, 1e-4) for m, f in floor.items()}
    rec = {"phase": "multi_window", "part": "reference", "card": card, "size": size,
           "batch": batch, "id_mismatches_clear": id_mismatch,
           "clear_share": float(clear.float().mean()), "loss_rel_err": loss_err,
           "grad_rel_err": grad_err, "grad_route_floor": floor, "grad_limit": grad_limit,
           "losses_cpu": m_cpu, "losses_card": out["card"][2],
           "tolerance": f"ids equal where the top-2 score gap > 1e-4·max|score|; losses rtol "
                        f"{rtol}; gradients (Adam's first moment) 5x the card's conv-route "
                        "floor or 1e-4"}
    emit(rec)
    if id_mismatch or any(loss_err[k] > rtol[k] for k in loss_err) or any(
            grad_err[m] > grad_limit[m] for m in grad_err):
        raise RuntimeError(f"card vs CPU joint step: {id_mismatch} clear id mismatches, loss "
                           f"errors {loss_err}, gradient errors {grad_err}")


def multi_window_run_part(device, workdir, overrides, *, seed=0):
    """(b) The multi-window trainer as a user runs it: `run_vqwnet.main -w`
    on the joint config (`overrides` shrinks it for a CPU rehearsal) over
    the trainer phase's slice tree in `workdir`, 2 epochs of 5 steps,
    saving every 3. Run A: 6 steps (the epoch-0 end's validation grids
    carry the discriminator's maps). Run B: stops at 3, resumes to 6; held
    to A (slice order, counters; parameters and Adam moments of encoder,
    decoder and discriminator, the spectral-norm vectors and the codebook
    within MW_RESUME_GAP_LIMIT). `-m test` writes the HU NIfTI export of
    every slice; one exported label map is painted and decoded through
    `edit_study` with the joint decoder. Launches are held to the derived
    counts. Off the counted path, a planted fault: B's step-3 save with the
    discriminator's Adam state and spectral-norm vectors dropped, resumed
    to 6; its gap is printed beside the resume's."""
    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import edit_study
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file, restore_state

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir)
    base = mw_config(overrides, run={"n_epochs": 2}, save={"save_every_n_steps": 3})
    base["dataset"]["root_dir_path"] = str(work / "data")
    model, ds = base["model"]["vqmodel"], base["dataset"]
    batch = int(ds["batch_size"])
    n_slices = sum(1 for _ in (work / "data").rglob("ct_img_*.npy"))
    steps_per_epoch = n_slices // batch
    eval_batches = -(-n_slices // batch)
    size = int(np.load(next((work / "data").rglob("ct_img_*.npy"))).shape[-1])
    total = 6
    if steps_per_epoch != 5:
        raise RuntimeError(f"the multi-window run needs 5 steps an epoch, has {steps_per_epoch}")

    def run(name, argv, **changes):
        return run_cli(work, base, name, ["-w", *argv], cuda, **changes)

    trainer, shapes = second_state(base, "cpu", seed, multi_window=True)
    n_enc = routed_convs(shapes.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(shapes.decoder, torch.zeros(1, int(model["enc_filters"][0]), size, size))
    params = {m: {k for k, _ in getattr(shapes, m).named_parameters()}
              for m in ("encoder", "decoder", "discriminator")}
    del trainer, shapes
    # runs A and B (B in two parts) take 2 × 6 joint steps; k-means (A, and
    # B's first part): one encoder forward; eval forwards (encoder, decoder,
    # one assignment): validation on 2 batches at the epoch-0 end of A and
    # of B's resume, the test over every test batch; the edit: one decoder
    # forward
    evals = 2 * 2 + eval_batches
    want = {"conv3x3_packed": (2 * n_enc + 2 * total * 4 * (n_enc + n_dec)
                               + evals * (n_enc + n_dec) + n_dec),
            "vq_fused": 2 * total * 2 + evals}
    if not cuda:
        want = {}
    elif str(model["knn_backend"]) not in ("pallas", "faiss"):
        want["vq_fused"] = 0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    # -- main path: train A, train B + resume, test, edit
    t0 = time.perf_counter()
    with captured_trainers() as trainers, captured_validation() as grids:
        run_a = run("wA", ["-m", "train", "--max-steps", str(total)])
        run_b = run("wB", ["-m", "train", "--max-steps", "3"])
        run("wB", ["-m", "train", "--max-steps", str(total)],
            run={"resume_checkpoint": str(run_b / "version_0" / "ckpt")})
        export_dir = work / "wT_export"
        run("wT", ["-m", "test"], run={"resume_checkpoint": str(run_a / "version_0" / "ckpt")},
            save={"save_dir": str(export_dir)})
        (trainer_a, steps_a), (_, steps_b), (_, steps_b2), (trainer_t, _) = trainers[:4]
        state = restore_state(str(run_a / "version_0" / "ckpt"), trainer_t.init_state())
        labels = sorted((export_dir / "pat00").glob("label_*.nii.gz"))
        ids = nifti.load(str(labels[0])).astype(np.int32)
        painted_dir, edited_dir = work / "wpainted", work / "wedited"
        painted_dir.mkdir()
        rng = np.random.default_rng(seed)
        nifti.save(paint(ids[None], rng, int(model["dict_size"]))[0],
                   str(painted_dir / labels[0].name), dtype=np.int32)
        edited = edit_study(state.decoder, state.vq, str(painted_dir), str(edited_dir),
                            batch_size=1, is_lung=True,
                            dataset_window=(ds["window_width"], ds["window_center"],
                                            ds["window_scale"]), device=device)
        if cuda:
            torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    del state

    steps_resumed = steps_b + steps_b2
    same_stream = len(steps_a) == len(steps_resumed) == total and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(steps_a, steps_resumed))
    last = f"ckpt-epoch=0001-step={total:08d}"
    final_a = load_state_file(str(run_a / "version_0" / "ckpt" / last))
    final_b = load_state_file(str(run_b / "version_1" / "ckpt" / last))

    def state_gap(x, y):
        """How far state y is from state x, per module: the parameters' RMS
        difference in learning rates and their largest difference, Adam's
        moments' relative difference (norm over all of them), the
        spectral-norm vectors' largest difference; and the codebook's
        relative difference."""
        gap = {}
        for part, opt in (("encoder", "enc_opt"), ("decoder", "dec_opt"),
                          ("discriminator", "dis_opt")):
            lr = float(base[f"{opt[:3]}_optim"]["lr"])
            keys = sorted(params[part])
            d = torch.cat([(x[part][k] - y[part][k]).flatten() for k in keys])
            sx, sy = x[opt]["state"], y[opt]["state"]
            mx = torch.cat([v.flatten() for i in sorted(sx) for k, v in sx[i].items()
                            if k != "step"])
            my = torch.cat([sy[i][k].flatten() if i in sy else torch.zeros_like(v).flatten()
                            for i in sorted(sx) for k, v in sx[i].items() if k != "step"])
            sn = [float((x[part][k] - y[part][k]).abs().max()) for k in x[part]
                  if k.endswith(("u0", "sv0"))]
            gap[part] = {"params_rms_lr": float(d.pow(2).mean().sqrt()) / lr,
                         "params_max": float(d.abs().max()),
                         "moments_rel": float((mx - my).norm() / mx.norm()),
                         "sn_max": max(sn, default=0.0)}
        ex, ey = x["encoder"]["vq.embed"], y["encoder"]["vq.embed"]
        gap["codebook"] = {"rel": float((ex - ey).norm() / ex.norm())}
        return gap

    gap = state_gap(final_a, final_b)
    counters = {"A": (final_a["step"], final_a["epoch"]), "B": (final_b["step"], final_b["epoch"])}
    warm = []
    for steps, first_step in ((steps_a, 1), (steps_b, 1), (steps_b2, 4)):
        t = dict(zip(range(first_step, first_step + len(steps)), (c for c, _ in steps)))
        warm += [t[k] - t[k - 1] for k in sorted(t) if k - 1 in t and (k - 1) % 3
                 and (k - 1) % steps_per_epoch]
    exported = sorted(p.name for p in export_dir.rglob("*.nii.gz"))
    n_export = {kind: sum(1 for f in exported if f.startswith(kind))
                for kind in ("image_", "recon_", "label_")}
    hu = nifti.load(str(sorted(export_dir.rglob("image_*.nii.gz"))[0]))
    out = nifti.load(str(edited_dir / edited[0]))

    # -- the planted fault, off the counted path
    faulty = load_state_file(str(run_b / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003"))
    faulty["dis_opt"]["state"] = {}
    gen = torch.Generator().manual_seed(seed)
    for k, v in faulty["discriminator"].items():
        if k.endswith("u0"):
            faulty["discriminator"][k] = torch.randn(v.shape, generator=gen)
        elif k.endswith("sv0"):
            faulty["discriminator"][k] = torch.ones_like(v)
    planted = work / "wplanted" / "ckpt-epoch=0000-step=00000003"
    planted.mkdir(parents=True)
    torch.save(faulty, planted / "state.pt")
    run_c = run("wC", ["-m", "train", "--max-steps", str(total)],
                run={"resume_checkpoint": str(planted)})
    planted_gap = state_gap(final_a, load_state_file(str(run_c / "version_0" / "ckpt" / last)))
    rec = {
        "phase": "multi_window", "part": "run", "device": str(device), "size": size,
        "batch": batch, "steps": total, "steps_per_epoch": steps_per_epoch,
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want, "path_s": path_s,
        "fit_step_s": warm, "fit_step_s_median": float(np.median(warm)) if warm else None,
        "same_batch_stream": same_stream, "counters": counters, "resume_gap": gap,
        "resume_gap_limit": MW_RESUME_GAP_LIMIT, "planted_fault_gap": planted_gap,
        "validation_grids": grids, "exported": n_export,
        "image_hu_range": [float(hu.min()), float(hu.max())],
        "edited_range": [float(out.min()), float(out.max())],
        "max_memory_allocated_bytes": peak, "card": nvidia_smi() if cuda else None,
    }
    emit(rec)

    def within(g):
        return all(g[part][k] <= limit for part, limits in MW_RESUME_GAP_LIMIT.items()
                   for k, limit in limits.items())

    checks = {
        "same_batch_stream": same_stream,
        "counters": counters["A"] == counters["B"] == (total, 1),
        "resume_gap": within(gap), "planted_fault_caught": not within(planted_gap),
        "validation_maps": len(grids) == 4 and all(g is not None and all(g) for g in grids),
        "exported": n_export == {"image_": n_slices, "recon_": n_slices, "label_": n_slices},
        "export_in_hu": hu.min() < -100.0 and hu.max() > 100.0,
        "edited": bool(np.isfinite(out).all() and out.min() >= -1.0 and out.max() <= 1.0),
        "launches": ({k: launches.get(k, 0) for k in want} == want) if cuda
        else launches == {},
    }
    if not all(checks.values()):
        raise RuntimeError(f"multi-window run: {checks}")
    return launches


# --------------------------------------------------------------------------
# the VQGAN trainer (`run_vqwnet -v`)
# --------------------------------------------------------------------------


def vqgan_config(overrides=None, **sections):
    """`configs/crc_vqgan.json` as a dict (see `second_config`)."""
    return second_config(overrides, path=VQGAN_CONFIG, **sections)


def vqgan_state(cfg, device, seed):
    """The VQGAN trainer's fresh state for `cfg` (a dict): the VQGAN as
    `seeded_init` fills it (random-normal codebook), the U-Net
    discriminator as the JAX module initialises, both Adams, the
    generator."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    trainer = Trainer(to_config(cfg), device=device, seed=seed, use_vqgan=True)
    return trainer, trainer.init_state()


def vqgan_flops(vqgan, batch, size):
    """Operations of the VQGAN's forward and backward at the step's shapes,
    counted by `torch.utils.flop_counter` on the meta device (the VQ
    assignment, outside the counter's operators, aside): (forward and
    backward, forward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(vqgan).to("meta")
    x = torch.zeros(batch, 1, size, size, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        meta.decoder(meta.encoder(x))
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        meta.decoder(meta.encoder(x)).sum().backward()
    return fc.get_total_flops(), fwd


def vqgan_phase(device, workdir, *, size=512, batch=8, steps=5, seed=0, overrides=None,
                ref_size=128, patients=2, slices=20):
    """The VQGAN trainer at the widths of `configs/crc_vqgan.json`
    (`overrides` shrinks it for a CPU rehearsal): (a) the bare step and a
    painted decode, (c) one step held to the CPU path on a small input,
    (b) the run through `run_vqwnet.main -v` over a seeded CRC tree in
    `workdir`. Returns the launches of (a) and (b)."""
    launches = vqgan_step_part(device, overrides, size=size, batch=batch, steps=steps,
                               seed=seed)
    vqgan_reference_part(overrides, size=ref_size, seed=seed + 1, card=device)
    run = vqgan_run_part(device, workdir, overrides, size=size, patients=patients,
                         slices=slices, seed=seed)
    return {k: launches.get(k, 0) + run.get(k, 0) for k in set(launches) | set(run)}


def vqgan_step_part(device, overrides, *, size, batch, steps, seed):
    """(a) `make_vqgan_step` through the trainer from seeded weights,
    `steps` steps under `MEDIMG_CONV_IMPL=packed` (the VQGAN's and the
    discriminator's convolutions are cuDNN's, so the conv kernel launches
    0 times), launches held to the derived counts (one assignment a step,
    the VQ kernel's instance for the config's codebook), peak memory; on
    the card one profiled warm step (busy, idle share, top kernels, the VQ
    kernel's device time and instance), the discriminator's work alone
    (its share of busy, its f32 rate against the operations counted from
    the model) and the VQGAN's forward and backward alone under the
    profiler. Then a painted bottleneck map decoded through
    `generate_image_from_ids`, timed."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops.vq_fused import kernel_path
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    cfg = vqgan_config(overrides)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    trainer, state = vqgan_state(cfg, device, seed)
    v = cfg["model"]["vqgan"]
    n_inner = trainer.second_cfg.n_inner_loops
    images = make_slices(np.random.default_rng(seed), batch, size)
    vq_on = str(cfg["model"]["vqmodel"]["knn_backend"]) in ("pallas", "faiss")
    want = {"conv3x3_packed": 0, "vq_fused": steps if vq_on else 0}
    before = {m: next(getattr(state, m).parameters()).detach().clone()
              for m in ("decoder", "discriminator")}
    counts0 = state.vq.cluster_size.clone()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _build.launches.clear()
    # -- main path: the steps
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, images)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    moved = {m: not torch.equal(b, next(getattr(state, m).parameters()).detach())
             for m, b in before.items()}
    moved["codebook"] = not torch.equal(counts0, state.vq.cluster_size)
    finite = all(np.isfinite(x) for m in losses for x in m.values())
    dis_flops, dis_fwd = dis_step_flops(state.discriminator, batch, size, n_inner)
    gen_flops, gen_fwd = vqgan_flops(state.decoder, batch, size)
    rec = {
        "phase": "vqgan", "part": "step", "device": str(device), "size": size, "batch": batch,
        "steps": steps, "n_inner_loops": n_inner, "vqgan": v, "dis": cfg["model"]["dis"],
        "vqgan_parameters": sum(p.numel() for p in state.decoder.parameters()),
        "dis_parameters": sum(p.numel() for p in state.discriminator.parameters()),
        "codebook": list(state.vq.embed.shape),
        "vq_instance": kernel_path(int(v["emb_dim"]), int(v["dict_size"])) if cuda else None,
        "launches": launches, "launches_expected": want if cuda else {},
        "step_s": step_s, "warm_step_s_median": float(np.median(step_s[1:] or step_s)),
        "losses_first": losses[0], "losses_last": losses[-1],
        "max_memory_allocated_bytes": peak,
        "vqgan_flop": gen_flops, "vqgan_forward_flop": gen_fwd, "dis_forward_flop": dis_fwd,
        "dis_step_flop": dis_flops, "dis_step_forward_equivalents": dis_flops / dis_fwd,
        "step_flop": gen_flops + dis_flops,
        "step_f32_floor_s": (gen_flops + dis_flops) / PEAK_F32_FLOP_PER_S,
    }
    x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
    if cuda:
        wall, kernels, union = profile_union(lambda: trainer.train_step(state, images))
        rec["profile"] = kernel_breakdown(wall, kernels, 12)
        rec["vq_path_seen"] = vq_path([e.key for e in kernels])
        busy = rec["profile"]["device_busy_s"]  # the kernels' times summed
        rec["device_busy_union_s"] = union
        rec["device_idle_share_of_warm_step"] = 1.0 - union / rec["warm_step_s_median"]
        rec["vq_share_of_step_busy"] = rec["profile"]["vq_fused_device_s"] / busy
        # the discriminator's work alone, on a copy, with one step's draws
        dis = copy.deepcopy(state.discriminator)
        dis_opt = torch.optim.Adam(dis.parameters(), lr=4e-4, betas=(0.5, 0.999))
        recon = torch.tanh(x + 0.1 * torch.randn_like(x))
        draws = sample_cutmix_draws(torch.Generator(device=device).manual_seed(seed), n_inner,
                                    size, size)
        dis_work(dis, x, recon, draws, dis_opt)
        dwall, dkernels, dunion = profile_union(lambda: dis_work(dis, x, recon, draws, dis_opt))
        del dis, dis_opt, recon
        dbusy = sum(device_us(e) for e in dkernels) / 1e6
        # the VQGAN's forward (train mode, on a copy) and backward alone
        gen = copy.deepcopy(state.decoder)

        def gen_work():
            r, c, _, _ = gen(x, train=True)
            ((r - x).pow(2).mean() + c).backward()

        gen_work()
        gwall, gkernels, gunion = profile_union(gen_work)
        del gen
        gbusy = sum(device_us(e) for e in gkernels) / 1e6
        rec.update({
            "dis_work_device_busy_s": dbusy, "dis_work_busy_union_s": dunion,
            "dis_share_of_step_busy": dbusy / busy,
            "dis_work_top": kernel_breakdown(dwall, dkernels, 6)["top"],
            "dis_achieved_f32_flop_per_s": dis_flops / dunion,
            "dis_share_of_f32_peak": dis_flops / dunion / PEAK_F32_FLOP_PER_S,
            "dis_f32_floor_s": dis_flops / PEAK_F32_FLOP_PER_S,
            "vqgan_work_device_busy_s": gbusy, "vqgan_work_busy_union_s": gunion,
            "vqgan_share_of_step_busy": gbusy / busy,
            "vqgan_work_top": kernel_breakdown(gwall, gkernels, 6)["top"],
            "vqgan_achieved_f32_flop_per_s": gen_flops / gunion,
        })
        torch.cuda.empty_cache()

    # the painted decode: the eval forward's bottleneck ids with a disc of
    # one code and a band of code 0
    from medical_image_editing_tpu_torch.train.evaluate import make_vqgan_eval_forward

    _, ids = make_vqgan_eval_forward(state.decoder, device=device)(images)
    painted = torch.as_tensor(paint(ids.cpu().numpy(), np.random.default_rng(seed),
                                    int(v["dict_size"]) - 1), device=device)
    vqgan = state.decoder.eval()
    with torch.inference_mode():
        out = vqgan.generate_image_from_ids(painted)
        sync()
        t0 = time.perf_counter()
        out = vqgan.generate_image_from_ids(painted)
        sync()
        rec["painted_decode_s"] = time.perf_counter() - t0
        if cuda:
            rec["painted_decode_ms"] = cuda_ms(lambda: vqgan.generate_image_from_ids(painted),
                                               warmup=1, iters=5)
    vqgan.train()
    rec.update({"painted_ids_shape": list(painted.shape), "painted_out_shape": list(out.shape),
                "painted_out_range": [float(out.min()), float(out.max())]})
    decoded = bool(torch.isfinite(out).all()) and tuple(out.shape) == (batch, 1, size, size)
    rec["card"] = nvidia_smi() if cuda else None
    emit(rec)
    del state, trainer, out, vqgan
    if cuda:
        torch.cuda.empty_cache()
    if not finite or not all(moved.values()) or not decoded:
        raise RuntimeError(f"VQGAN step: finite {finite}, moved {moved}, decoded {decoded}")
    if cuda and ({k: launches.get(k, 0) for k in want} != want
                 or rec["vq_path_seen"] != rec["vq_instance"]):
        raise RuntimeError(f"VQGAN step kernel launches {launches}, derived {want}; VQ "
                           f"instance {rec['vq_path_seen']}, expected {rec['vq_instance']}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")
    return launches


def vqgan_reference_part(overrides, *, size=128, batch=2, seed=1, card="cuda"):
    """One VQGAN step on the card vs the same step on the port's CPU path,
    at the config's widths in f32 (TF32 off) on a small input (128², the
    512 discriminator's smallest), the same weights and CutMix draws on
    both. Held: the ids where the top-2 score gap is clear of rounding, every
    loss (rtol 1e-3), the codebook after the step (rtol 1e-3), and the
    gradients of the VQGAN and the discriminator read from Adam's first
    moment (relative Frobenius error) within 5× the card's own floor or
    1e-4. The floor is the larger of two perturbations of the card's step
    at the rounding level: cuDNN off (another summation order), and the
    quantized features moved by one ulp up or down at random
    (`ulp_nudged_quantization`: at random init every id is one code, the
    decoder's input is constant over space, and its GroupNorm divides
    rounding noise by √eps). `card` is the device held to the CPU ("cpu"
    rehearses the comparison)."""
    import torch

    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws

    tf32_off()  # held to the CPU at full f32

    cfg = vqgan_config(overrides)
    images = make_slices(np.random.default_rng(seed), batch, size)
    trainer, state = vqgan_state(cfg, "cpu", seed)
    start = {m: copy.deepcopy(getattr(state, m).state_dict())
             for m in ("decoder", "discriminator")}
    draws = sample_cutmix_draws(torch.Generator().manual_seed(seed),
                                trainer.second_cfg.n_inner_loops, size, size)
    del state
    out = {}
    runs = [("cpu", "cpu", True, False), ("card", card, True, False)]
    if card == "cuda":
        runs += [("card_no_cudnn", card, False, False), ("card_ulp", card, True, True)]
    for name, device, use_cudnn, nudge in runs:
        trainer, state = vqgan_state(cfg, device, seed)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
            vqgan = state.decoder.eval()
            feats = vqgan.encoder(x).permute(0, 2, 3, 1)
            ids = vqgan(x, train=False)[2]
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        prev_cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = use_cudnn
        try:
            with ulp_nudged_quantization(seed) if nudge else contextlib.nullcontext():
                _, metrics = trainer.train_step(state, images, draws=on)
        finally:
            torch.backends.cudnn.enabled = prev_cudnn
        grads = {m: torch.cat([o.state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()])
                 for m, o in (("decoder", state.dec_opt), ("discriminator", state.dis_opt))}
        out[name] = (feats.cpu(), ids.cpu(), {k: float(v) for k, v in metrics.items()}, grads,
                     [t.cpu() for t in state.vq])
        del state, trainer
    feats, ids_cpu, m_cpu, g_cpu, vq_cpu = out["cpu"]
    top2 = vq_scores(start["decoder"]["vq.embed"],
                     feats.reshape(-1, feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(ids_cpu.shape)
    id_mismatch = int(((out["card"][1] != ids_cpu) & clear).sum())
    loss_err = {k: abs(out["card"][2][k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items()}
    grad_err = {m: float((out["card"][3][m] - g).norm() / g.norm()) for m, g in g_cpu.items()}
    codebook_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
                       for a, b in zip(out["card"][4], vq_cpu))
    variants = {name: {m: float((o[3][m] - g).norm() / g.norm())
                       for m, g in out["card"][3].items()}
                for name, o in out.items() if name.startswith("card_")}
    floor = {m: max([v[m] for v in variants.values()], default=0.0) for m in g_cpu}
    grad_limit = {m: max(5 * f, 1e-4) for m, f in floor.items()}
    rec = {"phase": "vqgan", "part": "reference", "card": card, "size": size, "batch": batch,
           "id_mismatches_clear": id_mismatch, "clear_share": float(clear.float().mean()),
           "loss_rel_err": loss_err, "grad_rel_err": grad_err, "grad_floor_variants": variants,
           "grad_floor": floor, "grad_limit": grad_limit, "codebook_rel_err": codebook_err,
           "losses_cpu": m_cpu, "losses_card": out["card"][2],
           "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; losses and "
                        "the codebook rtol 1e-3; gradients (Adam's first moment) 5x the "
                        "card's floor (cuDNN off; one-ulp quantized features) or 1e-4"}
    emit(rec)
    if id_mismatch or max(loss_err.values()) > 1e-3 or codebook_err > 1e-3 or any(
            grad_err[m] > grad_limit[m] for m in grad_err):
        raise RuntimeError(f"card vs CPU VQGAN step: {id_mismatch} clear id mismatches, loss "
                           f"errors {loss_err}, codebook {codebook_err}, gradient errors "
                           f"{grad_err}")


@contextlib.contextmanager
def ulp_nudged_quantization(seed=0):
    """Inside the block the VQGAN's quantized features move by one ulp up
    or down at random (the gradient still flows straight through)."""
    import torch

    from medical_image_editing_tpu_torch.models import vqgan as tvqgan

    real, gens = tvqgan.vq_apply, {}

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        gen = gens.setdefault(q.device, torch.Generator(device=q.device).manual_seed(seed))
        up = torch.randint(0, 2, q.shape, generator=gen, device=q.device).bool()
        moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
        return (q + (moved - q).detach(), *rest)

    tvqgan.vq_apply = nudged
    try:
        yield
    finally:
        tvqgan.vq_apply = real


def write_crc_tree(root, rng, *, patients, slices, size):
    """`patients` × `slices` CRC slices (`make_slices`, mapped from [-1, 1]
    back to 0-255) as `root/patNN/slice_SSSS.npy`, as `CRCDataset` walks
    them."""
    for p in range(patients):
        d = Path(root) / f"pat{p:02d}"
        d.mkdir(parents=True)
        img = (make_slices(rng, slices, size)[..., 0] + 1.0) * 127.5
        for s in range(slices):
            np.save(d / f"slice_{s:04d}.npy", img[s].astype(np.float32))


def vqgan_run_part(device, workdir, overrides, *, size, patients, slices, seed=0):
    """(b) The VQGAN trainer as a user runs it: `run_vqwnet.main -v` on
    `configs/crc_vqgan.json` (`overrides` shrinks it for a CPU rehearsal)
    over a seeded CRC tree of `patients` × `slices` slices of `size`² (5
    steps an epoch), 2 epochs. Run A: 6 steps. Run B: stops at 3, resumes
    to 6; held to A (slice order, counters; parameters and Adam moments of
    the VQGAN and the discriminator, the spectral-norm vectors and the
    codebook's EMA buffers within VQGAN_RESUME_GAP_LIMIT). `-m test` writes
    result.csv, the "inference" export writes the 0-based bottleneck label
    maps. Launches are held to the derived counts. Off the counted path, a
    planted fault: B's step-3 save with the codebook's EMA buffers dropped
    (counts 0, sums = the codebook), resumed to 6; its gap is printed
    beside the resume's."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir) / "vqgan"
    write_crc_tree(work / "data", np.random.default_rng(seed + 7), patients=patients,
                   slices=slices, size=size)
    base = vqgan_config(overrides, run={"n_epochs": 2})
    base["dataset"].update(root_dir_path=str(work / "data"), image_size=[size, size])
    batch = int(base["dataset"]["batch_size"])
    n_slices = patients * slices
    steps_per_epoch = n_slices // batch
    eval_batches = -(-n_slices // batch)
    total = 6
    if steps_per_epoch != 5:
        raise RuntimeError(f"the VQGAN run needs 5 steps an epoch, has {steps_per_epoch}")
    dict_size = int(base["model"]["vqgan"]["dict_size"])
    lr = {"decoder": float(base["dec_optim"]["lr"]),
          "discriminator": float(base["dis_optim"]["lr"])}

    def run(name, argv, **changes):
        return run_cli(work, base, name, ["-v", *argv], cuda, **changes)

    # runs A and B (B in two parts) take 2 × 6 steps, one assignment each;
    # eval forwards (one assignment each): validation on 2 batches at the
    # epoch-0 end of A and of B's resume, the test and the export over
    # every test batch; no convolution is routed to the conv kernel
    want = {"conv3x3_packed": 0, "vq_fused": 2 * total + 2 * 2 + 2 * eval_batches}
    if not cuda:
        want = {}
    elif str(base["model"]["vqmodel"]["knn_backend"]) not in ("pallas", "faiss"):
        want["vq_fused"] = 0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    # -- main path: train A, train B + resume, test, export
    t0 = time.perf_counter()
    with captured_trainers() as trainers, captured_validation() as grids:
        run_a = run("vA", ["-m", "train", "--max-steps", str(total)])
        run_b = run("vB", ["-m", "train", "--max-steps", "3"])
        run("vB", ["-m", "train", "--max-steps", str(total)],
            run={"resume_checkpoint": str(run_b / "version_0" / "ckpt")})
        run_t = run("vT", ["-m", "test"],
                    run={"resume_checkpoint": str(run_a / "version_0" / "ckpt")})
        run_i = run("vI", ["-m", "test"],
                    run={"training_mode": "inference",
                         "resume_checkpoint": str(run_a / "version_0" / "ckpt")})
        (_, steps_a), (_, steps_b), (_, steps_b2) = trainers[:3]
        if cuda:
            torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    steps_resumed = steps_b + steps_b2
    same_stream = len(steps_a) == len(steps_resumed) == total and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(steps_a, steps_resumed))
    last = f"ckpt-epoch=0001-step={total:08d}"
    final_a = load_state_file(str(run_a / "version_0" / "ckpt" / last))
    final_b = load_state_file(str(run_b / "version_1" / "ckpt" / last))
    params = {part: {k for k, v in final_a[part].items() if v.is_floating_point()
                     and not k.startswith("vq.") and not k.endswith(("u0", "sv0"))}
              for part in ("decoder", "discriminator")}

    def state_gap(x, y):
        """How far state y is from state x, for the VQGAN and the
        discriminator: the parameters' RMS difference in learning rates and
        their largest difference, Adam's moments' relative difference (norm
        over all of them), the spectral-norm vectors' largest difference;
        the codebook's embed, counts and sums, each a relative difference."""
        gap = {}
        for part, opt in (("decoder", "dec_opt"), ("discriminator", "dis_opt")):
            keys = sorted(params[part])
            d = torch.cat([(x[part][k] - y[part][k]).flatten() for k in keys])
            sx, sy = x[opt]["state"], y[opt]["state"]
            mx = torch.cat([v.flatten() for i in sorted(sx) for k, v in sx[i].items()
                            if k != "step"])
            my = torch.cat([sy[i][k].flatten() if i in sy else torch.zeros_like(v).flatten()
                            for i in sorted(sx) for k, v in sx[i].items() if k != "step"])
            sn = [float((x[part][k] - y[part][k]).abs().max()) for k in x[part]
                  if k.endswith(("u0", "sv0"))]
            gap[part] = {"params_rms_lr": float(d.pow(2).mean().sqrt()) / lr[part],
                         "params_max": float(d.abs().max()),
                         "moments_rel": float((mx - my).norm() / mx.norm()),
                         "sn_max": max(sn, default=0.0)}
        gap["codebook"] = {
            name: float((x["decoder"][f"vq.{name}"] - y["decoder"][f"vq.{name}"]).norm()
                        / x["decoder"][f"vq.{name}"].norm())
            for name in ("embed", "cluster_size", "embed_avg")}
        return gap

    gap = state_gap(final_a, final_b)
    counters = {"A": (final_a["step"], final_a["epoch"]), "B": (final_b["step"], final_b["epoch"])}
    warm = []
    for steps, first_step in ((steps_a, 1), (steps_b, 1), (steps_b2, 4)):
        t = dict(zip(range(first_step, first_step + len(steps)), (c for c, _ in steps)))
        warm += [t[k] - t[k - 1] for k in sorted(t) if k - 1 in t and (k - 1) % steps_per_epoch]
    result = list(csv.reader(open(run_t / "version_0" / "result.csv")))
    result_finite = len(result) == 2 and all(np.isfinite(float(x)) for x in result[1][1:])
    labels = sorted(run_i.rglob("label_*.nii.gz"))
    label_ids = nifti.load(str(labels[0])) if labels else np.zeros(0)
    bottleneck = size // 2 ** (len(base["model"]["vqgan"]["enc_ch_multiplier"]) - 1)

    # -- the planted fault, off the counted path
    faulty = load_state_file(str(run_b / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003"))
    faulty["decoder"]["vq.cluster_size"] = torch.zeros_like(faulty["decoder"]["vq.cluster_size"])
    faulty["decoder"]["vq.embed_avg"] = faulty["decoder"]["vq.embed"].t().clone()
    planted = work / "vplanted" / "ckpt-epoch=0000-step=00000003"
    planted.mkdir(parents=True)
    torch.save(faulty, planted / "state.pt")
    del faulty
    run_c = run("vC", ["-m", "train", "--max-steps", str(total)],
                run={"resume_checkpoint": str(planted)})
    planted_gap = state_gap(final_a, load_state_file(str(run_c / "version_0" / "ckpt" / last)))
    rec = {
        "phase": "vqgan", "part": "run", "device": str(device), "size": size, "batch": batch,
        "steps": total, "steps_per_epoch": steps_per_epoch, "slices": n_slices,
        "launches": launches, "launches_expected": want, "path_s": path_s,
        "fit_step_s": warm, "fit_step_s_median": float(np.median(warm)) if warm else None,
        "same_batch_stream": same_stream, "counters": counters, "resume_gap": gap,
        "resume_gap_limit": VQGAN_RESUME_GAP_LIMIT, "planted_fault_gap": planted_gap,
        "validation_grids": len(grids), "result_csv": result,
        "label_maps": len(labels), "label_shape": list(np.shape(label_ids)),
        "label_range": [int(label_ids.min()), int(label_ids.max())] if labels else None,
        "checkpoint_bytes": os.path.getsize(planted / "state.pt"),
        "max_memory_allocated_bytes": peak, "card": nvidia_smi() if cuda else None,
    }
    emit(rec)

    def within(g):
        return all(g[part][k] <= limit for part, limits in VQGAN_RESUME_GAP_LIMIT.items()
                   for k, limit in limits.items())

    checks = {
        "same_batch_stream": same_stream,
        "counters": counters["A"] == counters["B"] == (total, 1),
        "resume_gap": within(gap), "planted_fault_caught": not within(planted_gap),
        "validation_grids": len(grids) == 4 and all(g is None for g in grids),
        "result_csv": result_finite, "label_maps": len(labels) == n_slices,
        "labels_0_based": bool(labels) and label_ids.shape == (bottleneck, bottleneck)
        and 0 <= label_ids.min() and label_ids.max() < dict_size,
        "launches": ({k: launches.get(k, 0) for k in want} == want) if cuda
        else launches == {},
    }
    if not all(checks.values()):
        raise RuntimeError(f"VQGAN run: {checks}")
    return launches


# --------------------------------------------------------------------------
# the perceptual loss and DropBlock in the first stage
# --------------------------------------------------------------------------


def losses_config(overrides=None, kind="vgg", path=MODEL_CONFIG, **sections):
    """A config (the lung first stage's by default; see `second_config`)
    with only the switches turned on: the perceptual loss of `kind` at
    weight 1.0, `perceptual_fallback` logged, and DropBlock at the config's
    `block_size` and schedule."""
    base = second_config(overrides, path=path, **sections)
    base["loss"].update(use_perceptual_loss=True, perceptual_loss_type=kind)
    base["loss"]["loss_weight"]["perceptual"] = 1.0
    base["run"]["monitoring_metrics"] = [*base["run"]["monitoring_metrics"],
                                         "perceptual_fallback"]
    base["model"]["vqmodel"]["use_dropblock"] = True
    return base


def losses_step_fn(trainer, state, device):
    """The trainer's first-stage step on `state`'s models, with its
    perceptual loss."""
    import torch

    from medical_image_editing_tpu_torch.train.first_stage import make_first_stage_step

    return make_first_stage_step(state.encoder, state.decoder, loss_cfg=trainer.first_cfg,
                                 aug_cfg=trainer.aug_cfg, dict_size=trainer.dict_size,
                                 compute_dtype=trainer.compute_dtype or torch.float32,
                                 device=device, perceptual_fn=trainer.perceptual_fn)


def fork_first_state(cfg, state, device):
    """A copy of a first-stage state (modules, Adam states; the generator
    fresh): a step on it leaves `state` as it was."""
    from medical_image_editing_tpu_torch.train import state as tstate
    from medical_image_editing_tpu_torch.utils.config import to_config

    c = to_config(cfg)
    enc, dec = copy.deepcopy(state.encoder), copy.deepcopy(state.decoder)
    opts = []
    for module, section, src in ((enc, c.enc_optim, state.enc_opt),
                                 (dec, c.dec_optim, state.dec_opt)):
        opt = tstate.make_optimizer_from_config(module.parameters(), section)
        opt.load_state_dict(copy.deepcopy(src.state_dict()))
        opts.append(opt)
    return tstate.create_train_state(enc, dec, opts[0], opts[1], device=device)


def first_draws(trainer, state, generator, batch, size):
    """One step's draws from `generator`: the two views', then the two
    decodes' DropBlock uniforms."""
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.train.first_stage import view_dropblock_draws

    views = tuple(sample_view_draws(generator, trainer.aug_cfg, batch, size, size)
                  for _ in range(2))
    return views, view_dropblock_draws(generator, state.decoder, batch, size, size)


def vgg_work(vgg, image, recon):
    """The perceptual loss's work in one first-stage step, alone (NCHW):
    two views' losses (4 forwards) and their input gradients (2 backward
    passes; the weights are buffers)."""
    r = recon.detach().requires_grad_(True)
    (vgg(r, image) + vgg(r.flip(-1), image.flip(-1))).backward()


def vgg_reproducibility(vgg, image, recon):
    """The VGG work's input gradient taken twice through the module (its
    convolutions cuDNN's deterministic algorithms, `ops.perceptual.
    _frozen_conv`) and twice through the same network on plain
    `F.conv2d` autograd (PyTorch's default cuDNN heuristics): the largest
    difference between each pair, and each one's time (CUDA events)."""
    import torch
    import torch.nn.functional as F

    def plain(x):
        x = x.float().repeat(1, 3, 1, 1)
        for idx, kind in ((0, "C"), (2, "C"), (4, "M"), (5, "C"), (7, "C")):
            if kind == "M":
                x = F.max_pool2d(x, 2)
            else:
                conv = getattr(vgg.features, str(idx))
                x = F.conv2d(x, conv.weight, conv.bias, padding=1)
                x = F.relu(x) if idx + 1 < vgg.stop_index else x
        return x

    def plain_loss(r, t):
        return torch.mean((plain(r) - plain(t.detach())) ** 2)

    out = {}
    for name, fn in (("module", vgg), ("default_heuristics", plain_loss)):
        grads = []
        for _ in range(2):
            r = recon.detach().requires_grad_(True)
            (fn(r, image) + fn(r.flip(-1), image.flip(-1))).backward()
            grads.append(r.grad)
        out[f"{name}_grad_rerun_gap"] = float((grads[0] - grads[1]).abs().max())

        def work(fn=fn):
            r = recon.detach().requires_grad_(True)
            (fn(r, image) + fn(r.flip(-1), image.flip(-1))).backward()

        out[f"{name}_ms"] = cuda_ms(work, warmup=2, iters=10) if image.is_cuda else None
    return out


def vgg_work_flops(vgg, batch, size):
    """Operations of `vgg_work` at the step's shapes, counted by
    `torch.utils.flop_counter` on the meta device: (total, one forward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(vgg).to("meta")
    x = torch.zeros(batch, 1, size, size, device="meta")
    with FlopCounterMode(display=False) as fc:
        vgg_work(meta, x, x.clone())
    total = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        meta.feature_stack(x.repeat(1, 3, 1, 1))
    return total, fc.get_total_flops()


def losses_phase(device, workdir, *, size=256, batch=8, steps=5, seed=0, overrides=None,
                 vqgan_overrides=None, vqgan_size=512, ref_size=64, patients=2, slices=20):
    """The perceptual loss and DropBlock on the first stage's path (the
    lung first-stage config at full widths with the switches on;
    `overrides` shrinks it for a CPU rehearsal): (a) the bare step, (b)
    the LPIPS step, (c) the VQGAN step with the VGG loss, (d) one step held
    to the CPU path, (e) the run through `run_vqwnet.main` over the trainer
    phase's tree in `workdir`. Returns the launches of (a), (b), (c) and
    (e)."""
    parts = [losses_step_part(device, overrides, size=size, batch=batch, steps=steps,
                              seed=seed),
             losses_lpips_part(device, overrides, size=size, batch=batch, seed=seed),
             losses_vqgan_part(device, vqgan_overrides, size=vqgan_size, batch=batch,
                               seed=seed)]
    losses_reference_part(overrides, size=ref_size, seed=seed + 1, card=device)
    parts.append(losses_run_part(device, workdir, overrides, patients=patients, slices=slices))
    return {k: sum(p.get(k, 0) for p in parts) for k in set().union(*parts)}


def losses_step_part(device, overrides, *, size, batch, steps, seed):
    """(a) The first-stage step with the VGG loss (weight 1) and DropBlock
    (the config's block_size, drop_prob its stop_value) from seeded
    weights: codebook k-means, then `steps` steps with the packed conv
    route, the launches held to the train phase's derived counts (neither
    part adds one); on the card a profiled warm step (busy, idle, top
    kernels), the VGG's work alone (its device time, share of busy and f32
    rate against the operations counted on the meta device), peak memory,
    and one warm step under `tf32` against `ieee` from one state and draws
    (times, loss gap)."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    cfg = losses_config(overrides)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    trainer, state = second_state(cfg, device, seed)
    model = cfg["model"]["vqmodel"]
    drop = float(model["stop_value"])
    step = losses_step_fn(trainer, state, device)
    images = make_slices(np.random.default_rng(seed), batch, size)
    n_enc = routed_convs(state.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(state.decoder,
                         torch.zeros(1, int(model["enc_filters"][0]), size, size))
    vq_on = str(model["knn_backend"]) in ("pallas", "faiss")
    # the train phase's counts: k-means one encoder forward; each step both
    # views through encoder and decoder and every routed conv's input
    # gradient, two assignments
    want = {"conv3x3_packed": n_enc + steps * 4 * (n_enc + n_dec),
            "vq_fused": 2 * steps if vq_on else 0}
    before = [next(state.encoder.parameters()).detach().clone(),
              next(state.decoder.parameters()).detach().clone()]
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _build.launches.clear()
    # -- main path: codebook init, then the steps
    init_codebook_step(state.encoder)(state, images)
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, images, drop_prob=drop)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    moved = [not torch.equal(b, next(m.parameters()).detach())
             for b, m in zip(before, (state.encoder, state.decoder))]
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    vgg = trainer.perceptual_fn
    flops, fwd_flops = vgg_work_flops(vgg, batch, size)
    rec = {
        "phase": "losses", "part": "step", "device": str(device), "size": size,
        "batch": batch, "steps": steps, "compute_dtype": str(model["compute_dtype"]),
        "perceptual": "vgg", "perceptual_pretrained": vgg.pretrained,
        "perceptual_fallback": trainer.perceptual_fallback,
        "dropblock": {"block_size": int(model["block_size"]), "drop_prob": drop,
                      "levels": state.decoder.dropblock_levels()},
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want if cuda else {},
        "step_s": step_s, "warm_step_s_median": float(np.median(step_s[1:] or step_s)),
        "losses_first": losses[0], "losses_last": losses[-1],
        "max_memory_allocated_bytes": peak,
        "vgg_forward_flop": fwd_flops, "vgg_step_flop": flops,
        "vgg_step_forward_equivalents": flops / fwd_flops,
    }
    x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
    recon = torch.tanh(x + 0.1 * torch.randn_like(x))
    vgg_work(vgg, x, recon)
    if cuda:
        # one warm step under the profiler, then the VGG's work alone
        wall, kernels = profile_window(lambda: step(state, images, drop_prob=drop))
        rec["profile"] = kernel_breakdown(wall, kernels, 12)
        busy = rec["profile"]["device_busy_s"]
        rec["device_idle_share_of_warm_step"] = 1.0 - busy / rec["warm_step_s_median"]
        vwall, vkernels = profile_window(lambda: vgg_work(vgg, x, recon))
        vbusy = sum(device_us(e) for e in vkernels) / 1e6
        rec["vgg_reproducibility"] = vgg_reproducibility(vgg, x, recon)
        rec.update({
            "vgg_work_device_busy_s": vbusy, "vgg_share_of_step_busy": vbusy / busy,
            "vgg_work_top": kernel_breakdown(vwall, vkernels, 6)["top"],
            "vgg_achieved_f32_flop_per_s": flops / vbusy,
            "vgg_share_of_f32_peak": flops / vbusy / PEAK_F32_FLOP_PER_S,
            "vgg_f32_floor_s": flops / PEAK_F32_FLOP_PER_S,
        })
    # one step from one state and draws at full f32 and under TF32, then
    # three warm steps of each, timed
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    draws, db = first_draws(trainer, state, gen, batch, size)
    timed = {}
    for value in ("ieee", "tf32"):
        with conv_precision(value):
            fork = fork_first_state(cfg, state, device)
            fork_step = losses_step_fn(trainer, fork, device)
            _, m = fork_step(fork, images, draws, drop, db)
            times = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                fork_step(fork, images, draws, drop, db)
                sync()
                times.append(time.perf_counter() - t0)
            timed[value] = ({k: float(v) for k, v in m.items()}, times)
            del fork, fork_step
    tf32_off()
    m32, m_tf32 = timed["ieee"][0], timed["tf32"][0]
    rec.update({
        "ieee_warm_step_s": timed["ieee"][1], "tf32_warm_step_s": timed["tf32"][1],
        "ieee_warm_step_s_median": float(np.median(timed["ieee"][1])),
        "tf32_warm_step_s_median": float(np.median(timed["tf32"][1])),
        "tf32_loss_rel_gap": {k: abs(m_tf32[k] - v) / max(abs(v), 1e-12)
                              for k, v in m32.items()},
        "card": nvidia_smi() if cuda else None,
    })
    emit(rec)
    if not finite or not all(moved) or losses[0]["perceptual"] <= 0:
        raise RuntimeError(f"losses step: finite {finite}, moved {moved}, "
                           f"perceptual {losses[0]['perceptual']}")
    if cuda and rec["vgg_reproducibility"]["module_grad_rerun_gap"] != 0.0:
        raise RuntimeError(f"the VGG's input gradient is not reproducible: "
                           f"{rec['vgg_reproducibility']}")
    if cuda and {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"losses step kernel launches {launches}, derived {want}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")
    return launches


def losses_lpips_part(device, overrides, *, size, batch, seed, steps=2):
    """(b) Codebook k-means, then `steps` first-stage steps with
    `perceptual_loss_type: "lpips"` (and DropBlock), launches held: one
    encoder forward, then each step's four encoder and decoder passes and
    two assignments."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    cfg = losses_config(overrides, kind="lpips")
    cuda = torch.device(device).type == "cuda"
    trainer, state = second_state(cfg, device, seed)
    model = cfg["model"]["vqmodel"]
    step = losses_step_fn(trainer, state, device)
    images = make_slices(np.random.default_rng(seed + 2), batch, size)
    n_enc = routed_convs(state.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(state.decoder,
                         torch.zeros(1, int(model["enc_filters"][0]), size, size))
    vq_on = str(model["knn_backend"]) in ("pallas", "faiss")
    want = {"conv3x3_packed": n_enc + steps * 4 * (n_enc + n_dec),
            "vq_fused": 2 * steps if vq_on else 0}

    _build.launches.clear()
    # -- main path: codebook init, then the steps
    init_codebook_step(state.encoder)(state, images)
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, images, drop_prob=float(model["stop_value"]))
        if cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    emit({"phase": "losses", "part": "lpips", "device": str(device), "size": size,
          "batch": batch, "steps": steps, "perceptual_pretrained": trainer.perceptual_fn.pretrained,
          "launches": launches, "launches_expected": want if cuda else {}, "step_s": step_s,
          "losses_first": losses[0], "losses_last": losses[-1]})
    if not finite or losses[0]["perceptual"] <= 0:
        raise RuntimeError(f"lpips step: finite {finite}, perceptual {losses[0]['perceptual']}")
    if cuda and {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"lpips step kernel launches {launches}, derived {want}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")
    return launches


def losses_vqgan_part(device, overrides, *, size, batch, seed, steps=3):
    """(c) The VQGAN step at `configs/crc_vqgan.json`'s widths with the VGG
    loss on (weight 1): `steps` steps through the trainer, launches held
    (one assignment a step, no packed conv), peak memory against the
    card's."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build

    cfg = losses_config(overrides, path=VQGAN_CONFIG)
    cfg["model"]["vqmodel"]["use_dropblock"] = False  # the VQGAN has no DropBlock
    cuda = torch.device(device).type == "cuda"
    trainer, state = vqgan_state(cfg, device, seed)
    images = make_slices(np.random.default_rng(seed), batch, size)
    vq_on = str(cfg["model"]["vqmodel"]["knn_backend"]) in ("pallas", "faiss")
    want = {"conv3x3_packed": 0, "vq_fused": steps if vq_on else 0}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    _build.launches.clear()
    # -- main path: the steps
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, images)
        if cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    total = torch.cuda.get_device_properties(0).total_memory if cuda else None
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    emit({"phase": "losses", "part": "vqgan", "device": str(device), "size": size,
          "batch": batch, "steps": steps, "perceptual": "vgg",
          "launches": launches, "launches_expected": want if cuda else {}, "step_s": step_s,
          "warm_step_s_median": float(np.median(step_s[1:] or step_s)),
          "losses_first": losses[0], "losses_last": losses[-1],
          "max_memory_allocated_bytes": peak, "device_total_memory_bytes": total,
          "card": nvidia_smi() if cuda else None})
    del trainer, state
    if cuda:
        torch.cuda.empty_cache()
    if not finite or losses[0]["perceptual"] <= 0:
        raise RuntimeError(f"VQGAN step with VGG: finite {finite}, "
                           f"perceptual {losses[0]['perceptual']}")
    if cuda and {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"VQGAN step with VGG kernel launches {launches}, derived {want}")
    if not cuda and launches:
        raise RuntimeError(f"CPU tensors launched kernels: {launches}")
    return launches


def losses_reference_part(overrides, *, size=64, batch=2, seed=1, card="cuda"):
    """(d) One first-stage step with the VGG loss and DropBlock on the card
    vs the same step on the port's CPU path, at the config's widths in f32
    under `ieee`, on a small input, packed route: the same weights,
    codebook (k-means on the CPU), perceptual weights (the seeded
    fallback), view draws, DropBlock draws and drop_prob. Held as the train
    phase holds its step: the ids where the top-2 score gap is clear of
    rounding, every loss rtol 1e-3 (1e-2 for cross, dist and total). `card`
    is the device held to the CPU ("cpu" rehearses the comparison)."""
    import torch

    from medical_image_editing_tpu_torch.models.unet_encoder import encode_quantize
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    cfg = losses_config(overrides)
    cfg["model"]["vqmodel"]["compute_dtype"] = "float32"
    drop = float(cfg["model"]["vqmodel"]["stop_value"])
    images = make_slices(np.random.default_rng(seed), batch, size)
    trainer, state = second_state(cfg, "cpu", seed)
    init_codebook_step(state.encoder)(state, images)
    start = (copy.deepcopy(state.encoder.state_dict()), copy.deepcopy(state.decoder.state_dict()))
    draws, db = first_draws(trainer, state, torch.Generator().manual_seed(seed), batch, size)

    def to(d, device):
        if isinstance(d, torch.Tensor):
            return d.to(device)
        if isinstance(d, dict):
            return {k: to(v, device) for k, v in d.items()}
        if isinstance(d, (list, tuple)):
            return type(d)(to(v, device) for v in d)
        return d

    out = {}
    with conv_precision("ieee"):
        for device in ("cpu", card):
            trainer, state = second_state(cfg, device, seed)
            state.encoder.load_state_dict(start[0])
            state.decoder.load_state_dict(start[1])
            with torch.no_grad():
                x = torch.as_tensor(images, device=device)
                feats = state.encoder.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                _, _, ids, _ = encode_quantize(state.encoder, state.vq, x, train=False,
                                               backend=state.encoder.knn_backend)
            _, metrics = losses_step_fn(trainer, state, device)(
                state, images, to(draws, device), drop, to(db, device))
            out[device] = (feats.cpu(), ids.cpu(), {k: float(v) for k, v in metrics.items()})
        tf32_off()
    feats, ids_cpu, m_cpu = out["cpu"]
    top2 = vq_scores(start[0]["vq.embed"], feats.reshape(-1, feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(ids_cpu.shape)
    id_mismatch = int(((out[card][1] != ids_cpu) & clear).sum())
    loss_err = {k: abs(out[card][2][k] - v) / max(abs(v), 1e-6) for k, v in m_cpu.items()}
    rtol = {k: 1e-2 if k in ("cross", "total", "dist") else 1e-3 for k in loss_err}
    emit({"phase": "losses", "part": "reference", "size": size, "batch": batch,
          "conv_precision": "ieee", "id_mismatches_clear": id_mismatch,
          "clear_share": float(clear.float().mean()), "loss_rel_err": loss_err,
          "losses_cpu": m_cpu, "losses_card": out[card][2],
          "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; "
                       f"losses rtol {rtol}"})
    if id_mismatch or any(loss_err[k] > rtol[k] for k in loss_err) or m_cpu["perceptual"] <= 0:
        raise RuntimeError(f"card vs CPU step with the VGG loss and DropBlock: {id_mismatch} "
                           f"clear id mismatches, loss errors {loss_err}")


@contextlib.contextmanager
def recorded_drop_probs():
    """The (epoch, drop_prob) of every training step that the trainers
    built inside the block take, in order."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer

    make, seen = Trainer._make_step, []

    def wrapped(self, state):
        step = make(self, state)

        def recorded(state, image, draws=None, drop_prob=0.0):
            seen.append((int(state.epoch), drop_prob))
            return step(state, image, draws, drop_prob=drop_prob)

        return recorded

    Trainer._make_step = wrapped
    try:
        yield seen
    finally:
        Trainer._make_step = make


def losses_run_part(device, workdir, overrides, *, patients=2, slices=20):
    """(e) The first stage with the VGG loss and DropBlock as a user runs
    it: `run_vqwnet.main` on the switched-on config over the trainer
    phase's seeded tree in `workdir` (5 steps an epoch at batch 8), 2
    epochs, under `ieee`. Run A trains 10 steps; run B stops at step 3,
    inside epoch 0, and resumes to 10 across the epoch end, where the
    schedule moves drop_prob. Held: the same batches in the same order,
    the counters, the final parameters and codebook with a gap of 0,
    `perceptual_fallback` 1.0 in every logged step, each step's drop_prob
    the schedule's at its epoch, a checkpoint's keys those of one written
    with both switches off, and the launches derived from the model. The
    precision that the CLIs set by default is read once, and printed."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops.dropblock import dropblock_schedule
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_file,
    )
    from medical_image_editing_tpu_torch.utils.config import to_config

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir)
    base = losses_config(overrides)
    base["dataset"]["root_dir_path"] = str(work / "data")
    base["run"]["n_epochs"] = 2
    base["save"]["save_every_n_steps"] = 3
    model, ds = base["model"]["vqmodel"], base["dataset"]
    batch = int(ds["batch_size"])
    steps_per_epoch = patients * slices // batch
    total_steps, stop = 2 * steps_per_epoch, 3
    schedule = tuple(float(model[k]) for k in ("start_value", "stop_value")) + (
        int(model["nr_steps"]),)
    off = copy.deepcopy(base)
    off["loss"]["use_perceptual_loss"] = off["model"]["vqmodel"]["use_dropblock"] = False
    shapes = Trainer(to_config(off), device="cpu").init_state()
    size = int(np.load(next((work / "data").rglob("*.npy"))).shape[-1])
    n_enc = routed_convs(shapes.encoder, torch.zeros(1, int(model["in_channels"]), size, size))
    n_dec = routed_convs(shapes.decoder,
                         torch.zeros(1, int(model["enc_filters"][0]), size, size))
    off_ckpt = CheckpointManager(str(work / "losses_off_probe")).save(shapes, 0)
    off_state = load_state_file(off_ckpt)
    del shapes
    vq_on = cuda and str(model["knn_backend"]) in ("pallas", "faiss")
    # A and B take 2 × total_steps steps, k-means twice (A, B's first part),
    # and validate 2 batches at each of the 4 epoch ends
    evals = 4 * 2
    want = {"conv3x3_packed": (2 * n_enc + 2 * total_steps * 4 * (n_enc + n_dec)
                               + evals * (n_enc + n_dec)),
            "vq_fused": 2 * total_steps * 2 + evals}
    if not cuda:
        want = {}
    elif not vq_on:
        want["vq_fused"] = 0

    _build.launches.clear()
    # -- main path: train A, train B + resume
    with captured_trainers() as trainers, recorded_drop_probs() as drops:
        run_a = run_cli(work, base, "LA", ["-m", "train"], cuda)
        run_b = run_cli(work, base, "LB", ["-m", "train", "--max-steps", str(stop)], cuda)
        run_cli(work, base, "LB", ["-m", "train"], cuda,
                run={"resume_checkpoint": str(run_b / "version_0" / "ckpt")})
        if cuda:
            torch.cuda.synchronize()
    launches = dict(_build.launches)

    (trainer_a, steps_a), (_, steps_b), (_, steps_b2) = trainers[:3]
    steps_resumed = steps_b + steps_b2
    same_stream = len(steps_a) == len(steps_resumed) == total_steps and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(steps_a, steps_resumed))
    final_a = load_state_file(str(run_a / "version_0" / "ckpt" / "ckpt-epoch=0001"))
    final_b = load_state_file(str(run_b / "version_1" / "ckpt" / "ckpt-epoch=0001"))
    params = {part: {k for k, _ in getattr(trainer_a.init_state(), part).named_parameters()}
              for part in ("encoder", "decoder")}
    gap = {part: max(float((final_a[part][k] - final_b[part][k]).abs().max())
                     for k in params[part]) for part in params}
    ea, eb = final_a["encoder"]["vq.embed"], final_b["encoder"]["vq.embed"]
    gap["codebook_rel"] = float((ea - eb).norm() / ea.norm())
    counters = {"A": (final_a["step"], final_a["epoch"]), "B": (final_b["step"], final_b["epoch"])}
    logged = [list(csv.DictReader(open(p / "log.csv"))) for p in
              (run_a / "version_0", run_b / "version_0", run_b / "version_1")]
    fallback = [float(r["perceptual_fallback"]) for rows in logged for r in rows]
    drop_by_epoch = {}
    for epoch, p in drops:
        drop_by_epoch.setdefault(epoch, set()).add(p)
    schedule_ok = len(drops) == 2 * total_steps and all(
        p == dropblock_schedule(epoch, *schedule) for epoch, p in drops)
    keys_same = (final_a.keys() == off_state.keys() and all(
        final_a[part].keys() == off_state[part].keys() for part in ("encoder", "decoder")))
    with conv_precision(None) as default:
        default_flags = {"applied": default, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                         "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    tf32_off()
    print(f"CLI default conv precision: {default_flags}", flush=True)
    rec = {
        "phase": "losses", "part": "run", "device": str(device), "batch": batch,
        "steps": total_steps, "steps_per_epoch": steps_per_epoch, "resume_after": stop,
        "conv_precision": "ieee", "cli_default_conv_precision": default_flags,
        "routed_convs": {"encoder": n_enc, "decoder": n_dec},
        "launches": launches, "launches_expected": want,
        "same_batch_stream": same_stream, "counters": counters, "resume_gap": gap,
        "resume_gap_limit": 0.0, "perceptual_fallback_logged": sorted(set(fallback)),
        "logged_steps": len(fallback),
        "drop_prob_by_epoch": {e: sorted(v) for e, v in sorted(drop_by_epoch.items())},
        "drop_prob_schedule": {e: dropblock_schedule(e, *schedule) for e in (0, 1)},
        "checkpoint_keys_as_switches_off": keys_same, "card": nvidia_smi() if cuda else None,
    }
    emit(rec)
    checks = {
        "same_batch_stream": same_stream,
        "counters": counters["A"] == counters["B"] == (total_steps, 2),
        "resume_gap": all(v == 0.0 for v in gap.values()),
        "perceptual_fallback": len(fallback) == 2 * total_steps and set(fallback) == {1.0},
        "drop_prob_schedule": schedule_ok and sorted(drop_by_epoch) == [0, 1],
        "checkpoint_keys": keys_same,
        "cli_default": default_flags["applied"] == "tf32" and default_flags["cudnn_allow_tf32"]
        and not default_flags["matmul_allow_tf32"],
        "launches": ({k: launches.get(k, 0) for k in want} == want) if cuda
        else launches == {},
    }
    if not all(checks.values()):
        raise RuntimeError(f"losses run: {checks}")
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernel-only", action="store_true",
                        help="build the VQ kernel and run only the device and kernel "
                             "phases, with no result line: for holding two checkouts' "
                             "VQ kernels to each other in one call")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    info = device_phase()
    if args.kernel_only:
        build_phase(["vq_fused"])
        kernel_phase("cuda", seed=args.seed)
        return 0
    build_phase()
    vq_points = kernel_phase("cuda", seed=args.seed)
    vq = vq_points[0]
    conv = conv_kernel_phase("cuda", seed=args.seed)
    model = json.loads(MODEL_CONFIG.read_text())["model"]["vqmodel"]
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, served = serve_phase("cuda", model, tmp, seed=args.seed)
    profile_phase(served)
    painted = served.painted
    del served
    with tempfile.TemporaryDirectory() as tmp:
        runtime_launches = serve_runtime_phase("cuda", model, painted, tmp, seed=args.seed)
    cfg = load_config()
    with conv_route("packed"):
        train_launches, trained = train_phase("cuda", cfg, seed=args.seed)
        train_profile_phase(trained)
        bare_step_s = trained.warm_s
        del trained
        train_reference_phase(cfg, seed=args.seed + 1)
        with tempfile.TemporaryDirectory() as tmp:
            trainer_launches = trainer_phase("cuda", tmp, seed=args.seed,
                                             bare_step_s=bare_step_s)
            second_launches = second_stage_phase("cuda", tmp, seed=args.seed)
            mw_launches = multi_window_phase("cuda", tmp, seed=args.seed)
            vqgan_launches = vqgan_phase("cuda", tmp, seed=args.seed)
            losses_launches = losses_phase("cuda", tmp, seed=args.seed)

    main_conv = next(r for r in conv if r["dtype"] == "bfloat16" and "forward" in r
                     and (r["cin"], r["cout"], r["h"]) == CONV_POINTS[0])
    emit({"kernels": [{
        "name": "vq_fused", "route": "cuda", "source": VQ_SOURCE,
        "replaces": VQ_REPLACES,
        "launches": (serve_launches.get("vq_fused", 0) + train_launches.get("vq_fused", 0)
                     + trainer_launches.get("vq_fused", 0)
                     + second_launches.get("vq_fused", 0) + mw_launches.get("vq_fused", 0)
                     + vqgan_launches.get("vq_fused", 0) + losses_launches.get("vq_fused", 0)),
        "launches_by_path": {"serve": serve_launches.get("vq_fused", 0),
                             "train": train_launches.get("vq_fused", 0),
                             "trainer": trainer_launches.get("vq_fused", 0),
                             "second_stage": second_launches.get("vq_fused", 0),
                             "multi_window": mw_launches.get("vq_fused", 0),
                             "vqgan": vqgan_launches.get("vq_fused", 0),
                             "losses": losses_launches.get("vq_fused", 0)},
        "max_abs_err": vq["sums_max_abs_err"],
        "id_mismatches_near_tie": vq["id_mismatches_near_tie"],
        "n": vq["n"], "c": vq["c"], "k": vq["k"], "path": vq["path"],
        "ms": vq["ms"], "device_ms": vq["device_ms"], "plain_ms": vq["plain_ms"],
        "bound_ms": vq["bound_ms"], "bound_by": vq["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes assign + lookup + "
                        "per-code counts and sums",
        "points": [{k: r[k] for k in ("n", "c", "k", "path", "ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by")} for r in vq_points],
    }, {
        "name": "conv3x3_packed", "route": "cuda", "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": (train_launches.get("conv3x3_packed", 0)
                     + runtime_launches.get("conv3x3_packed", 0)
                     + trainer_launches.get("conv3x3_packed", 0)
                     + second_launches.get("conv3x3_packed", 0)
                     + mw_launches.get("conv3x3_packed", 0)
                     + vqgan_launches.get("conv3x3_packed", 0)
                     + losses_launches.get("conv3x3_packed", 0)),
        "launches_by_path": {"serve": serve_launches.get("conv3x3_packed", 0),
                             "serve_bf16_packed": runtime_launches.get("conv3x3_packed", 0),
                             "train": train_launches.get("conv3x3_packed", 0),
                             "trainer": trainer_launches.get("conv3x3_packed", 0),
                             "second_stage": second_launches.get("conv3x3_packed", 0),
                             "multi_window": mw_launches.get("conv3x3_packed", 0),
                             "vqgan": vqgan_launches.get("conv3x3_packed", 0),
                             "losses": losses_launches.get("conv3x3_packed", 0)},
        "max_abs_err": main_conv["forward_max_abs_err"],
        "shape": {"b": main_conv["b"], "cin": main_conv["cin"], "cout": main_conv["cout"],
                  "h": main_conv["h"], "w": main_conv["w"], "dtype": "bfloat16",
                  "direction": "forward"},
        **{k: main_conv["forward"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
        "library_note": "F.conv2d (cuDNN) at the same shape and dtype",
        "points": [{"dtype": r["dtype"], "path": r["path"], "dir": d, "b": r["b"],
                    "cin": r[d]["cin"], "cout": r[d]["cout"], "h": r["h"],
                    **{k: r[d][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "vs_library", "device_ms", "library_device_ms")}}
                   for r in conv if "forward" in r for d in ("forward", "dx")],
    }]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
