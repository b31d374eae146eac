#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`medical_image_editing_tpu_torch`) on
one CUDA card: the quickest proof that the port starts on the GPU.

    python3 chip_smoke.py [--seed 0] [--only vq|conv|int8]

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
  4. conv    — the 3×3 conv kernel's three instances, forward and input
               gradient (dx held to autograd through the plain forward,
               not to the flipped weights the kernel runs on), each
               against its plain version at every (Cin,
               Cout, H) the training step gives it, batch 8, plus a ragged
               shape: bf16 (`conv3x3_mma_kernel`, mma.sync) and f32
               (`conv3x3_f32_kernel`, CUDA cores, true f32) under the run's
               `ieee`, and f32 under `conv_precision("tf32")`
               (`conv3x3_tf32_kernel`, TF32 mma.sync; also held to the
               unrounded f32 convolution); two runs bit for bit, NHWC equal
               to NCHW, only the instance the precision picks counted;
               timed beside the plain version, cuDNN's `F.conv2d` in the
               same precision (`vs_library` = kernel / cuDNN; f32 instances
               also beside cuDNN in the other precision) and the bound at
               the instance's rate, with CUDA events around 50 calls (`ms`:
               what a caller waits, the wrapper's host work included) and
               with the profiler (`device_ms`: the kernel's own device
               time, `kernel`: the template instance that ran);
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
               (d) `edit_partition`: the painted batch decoded partitioned
               (`make_batched_edit_fn(mesh=, partition=)`) on gloo ranks
               sharing the card: "data" on 2 ranks, "spatial" on 1 × 2 and
               2 × 2 (row halos, sharded instance norms), f32 on the xla
               route, bf16 on the packed kernel, int8 on 1 × 2; each held to
               the one-process decode within limits from a spread of
               ulp-nudged one-process decodes, a planted zero-halo fault
               above them, collectives and packed-kernel launches a rank as
               derived from the model, `edit_batch --partition spatial` on
               2 ranks and under a one-rank NCCL group (bit for bit); then
               on two of the ranks the partitioned services: `serve_http`
               on 1 × 2 "spatial" (bf16, packed) and 2 × 1 "data" (f32)
               behind a local port (the batch, one map, three maps padded
               under "data", a PNG, a label past the codebook answered 400
               and the next request 200, warm repeats; each answer held to
               the one-process decode within the mode's limits; rank 1
               following, decoding each request and ending at stop; packed
               launches 10 a rank a decode in bf16, 0 in f32, VQ 0), and
               `run_recon.serve` on 1 × 2 (one Processing, one Skip, PNGs
               from rank 0 only, its recon within the f32 limits);
  6c. int8  — the int8 serving decode at the same widths, 512²: (a) the
               four kernels of `csrc/conv_s8.cu` (channel absmax, the weight
               fold, s8 quantize, the s8×s8→s32 convolution on wgmma)
               against their plain versions bit for bit at every distinct
               convolution of the decoder (batch 8, seeded inputs): maxima,
               weight codes and scales, codes, int32 sums, outputs; each
               timed (`ms`, `device_ms`) beside its bound, its plain
               version and its calls per decode; yardsticks at the
               32 → 32 3×3 convolution: `torch._int_mm` over an im2col of
               the same codes (with and without the im2col), cuDNN's bf16
               `F.conv2d` and the packed bf16 kernel; (b)
               `make_batched_edit_fn(quantize="int8")` on the 8 painted
               maps and on 32 with `microbatch=8`, launches of each kernel
               held to the decoder's `Conv` count a chunk, each decode
               bit for bit the same decode through the plain versions on
               the card, the error against f32 framed as the JAX package's
               contract (int8 ≤ 4× bf16), 8 slices timed in f32, bf16
               cuDNN, bf16 packed and int8 with peak memory, 32 with
               `microbatch=8` in f32, bf16 packed and int8, both int8
               decodes profiled (idle share also against the unprofiled
               time); (c) `edit_batch.main --dtype int8` over
               the painted NIfTIs, held to the same decode; (d) after all
               phases, 0 int8 launches on every other path;
  7. train   — the first-stage training step at the same widths, with the
               config's augmentation, losses, optimizers and bf16 compute
               dtype, `MEDIMG_CONV_IMPL=packed`, 256², batch 8: codebook
               k-means on the first batch (`init_codebook_step`), then 5 steps
               (`make_first_stage_step`); the launch counts of both kernels
               held to the counts derived from the model; one warm step under
               the profiler; one step on the card held to the port's CPU path
               on a small input;
  7b. f32_step — the f32 readout of the conv's two f32 instances: the
               lung first stage at its config's widths in float32, 256²,
               batch 8, one k-means-initialised state forked four times:
               1 + 2 steps on each of {ieee, tf32} × {packed, xla} (step
               times, a profiled warm step with each instance's device
               time, launches by instance held to the derived counts, the
               first step's loss gap packed − xla in each precision); the
               main path of the f32 instances;
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
  8a. prior — the autoregressive prior (`cli/train_prior.py` →
               `train/prior.py` → `models/mingpt.py`) at the CLI's width (8
               layers, 8 heads, n_embed 256, dropout 0.1) over 64² id grids
               (T = 4,096 tokens, batch 2): (a) 3 bare steps (warm step,
               peak memory beside the derived T × T bytes, a profiled warm
               step: busy, idle share), one sampler call of 2 grids
               (seconds, tokens/s; the token step a CUDA graph, held bit for
               bit to `sample_token_step` run eagerly), the cached
               decode's logits over the first 256 positions held to the
               full forward's within 5× the spread of rounding-level full
               forwards; (c) one step and
               a 16-position cached decode at 8², full width, on the card
               held to the CPU path, the gradients to a float64 CPU witness;
               (b) `train_prior.main` over a seeded 64² lung tree, freezing
               the trainer phase's run-A checkpoint at the lung widths
               (`--steps 3 --batch 2 --sample 2`): files, shapes, ranges,
               step lines, the packed kernel's `ieee` launches held to 3
               encoder forwards and 1 decoder forward of routed convs, 0 VQ
               launches (the CLI's encoder takes the plain assignment, as
               JAX's does); then, off the counted path, the kernel's f32
               instance at each of those convs' (B, Cin, Cout, H, W) held
               to its plain version;
  8b. second_stage — the second (adversarial) stage at the widths of
               `configs/lung_second_stage.json` (bf16 encoder and decoder,
               the f32 U-Net discriminator at D_ch 64, packed conv, 256²,
               batch 8): (a) 3 bare steps of `make_second_stage_step`
               after the codebook k-means, launch counts held to the derived
               ones; a profiled warm step (busy, idle, top kernels), the
               discriminator's work alone under the profiler (its share of
               busy, its f32 rate against the operations counted from the
               model), peak memory, a warm step with cuDNN's TF32 on (time,
               loss gap); one step on the card held to the CPU path on a
               small input, its gradients to a float64 CPU witness on the
               run's own ids (fault C.6); (b) `run_vqwnet.main` on the second-stage config
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
               256², batch 8): (a) k-means, then 2 bare joint steps (two
               views, 6 generator-pass and 18 discriminator-pass forwards
               of the discriminator), launch counts held to the derived
               ones, peak memory, a profiled warm step (busy, idle, top
               kernels), the discriminator's work alone (its share of busy,
               its f32 rate against the operations counted from the model);
               2 bare steps each of the multi-window first and second
               steps, launches held; (c) one joint step on the card held to
               the CPU path on a small input, its gradients to a float64
               CPU witness (C.6); (b) `run_vqwnet.main -w` over
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
               512², batch 8: (a) 2 bare steps of `make_vqgan_step`,
               launches held (one assignment a step, the instance seen by
               the profiler), peak memory, a profiled warm step (busy, idle,
               top kernels, the VQ kernel's share), the discriminator's work
               and the VQGAN's forward and backward alone (shares of busy,
               f32 rates against the operations counted from the models), a
               painted 16² bottleneck map decoded through
               `generate_image_from_ids`; (c) one step at 128², batch 2, f32,
               on the card held to the CPU path, its gradients to a float64
               CPU witness (C.6); (b) `run_vqwnet.main -v`
               over a seeded CRC tree of 2 × 20 slices of 256²
               (VQGAN_RUN_SIZE; the config's 512² in (a)): run A 6
               steps, run B 3 and a resume to 6 held to A within
               VQGAN_RESUME_GAP_LIMIT, `-m test` (result.csv), the
               "inference" export of the 0-based label maps, launches held,
               and two planted faulty resumes whose gaps are printed: the
               codebook's EMA buffers dropped (caught by the limits), the
               discriminator's Adam moments dropped (caught by the
               discriminator's limits);
  8e. losses — the perceptual loss and DropBlock on the lung first stage's
               path (`configs/lung_first_stage.json` at full widths with
               only the switches on: the VGG19 loss at weight 1.0 on its
               seeded fallback, DropBlock at block_size 30), bf16, packed,
               256², batch 8: (a) k-means and 3 bare steps at drop_prob
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
  8f. volumetric — the 3-D volumetric VQ-WNet at BASELINE config #5's
               widths (filters 8,16,32,64, `dict_size` 10, 128³, batch 2, on
               seeded synthetic volumes): (a) `init_volumetric` and 3 bare
               steps of `make_volumetric_train_step` in f32 and in bf16 with
               remat (the JAX package's memory plan): warm step, a profiled
               warm step (busy, idle, top kernels), the rate against the
               operations counted from the model, peak memory, f32 steps
               timed under TF32 and `cudnn.benchmark`, the bf16 losses'
               gap to f32; (b) `train_volumetric.main` (6 steps over
               4 volumes: the step lines, the checkpoint, `recon_mid.png`),
               a volume encoded with the trained weights, a box of its ids
               painted, decoded through `edit_volume.main` from `.npy`,
               `.nii.gz` and as uint8, the time per decoded volume, a label
               past the codebook refused; (c) one f32 step at 32³, batch 2,
               at full widths on the card held to the CPU path, TF32
               asserted off, and the card's instance norm at 128³ against
               float64; (d) both kernels held at 0 launches on (a) and (b):
               the path runs the plain VQ assignment and cuDNN's conv3d, as
               the JAX path takes neither Pallas kernel;
  8g. ckpt_crossing — fault C.4 and the crossings: `run_vqwnet.main`
               trains the lung first stage (its widths, f32, 256²) for 2
               steps, `export_ckpt` writes the reference `.ckpt`,
               `import_ckpt` reads it back; `run_recon.load_model` with
               `LUNG_CKPT` at the imported directory and at the run's own
               decodes a painted batch bit for bit as the trained state's
               own modules do, and the imported tensors equal the run's;
  8h. ddp   — data-parallel first-stage training (ROADMAP 15(i)) at the
               lung config's full widths (bf16, packed conv, 256²): (a) two
               ranks sharing the card, each a spawned process in a gloo
               group (NCCL refuses two ranks on one device), 4 rows each:
               the Trainer's replicated state, the gathered k-means and 3
               steps, the ranks' states bit for bit equal after each step;
               held to one process on the 8 rows with the same draws, the
               VQ statistics averaged and the ranks' VQ ids replayed, after
               the first step, in bf16 and in f32 (DDP_GAP_LIMIT), and a
               planted fault (rank 1's gradients skip the average) that
               must land above the decoder's limit (DDP_FAULT_KEYS);
               launches per rank held to the derived
               counts, collectives and bytes a step; (b) `run_vqwnet -m
               train --max-steps 3` under a one-rank NCCL group made from
               a torchrun environment, bit for bit the run without one
               (both run while the ranks of (a) run, as do the GAN
               trainers' (b) runs), and the bare step timed with and
               without that group (after the ranks are joined); then
               the GAN trainers (ROADMAP 15(ii)) at their configs' full
               widths in f32: (a) on the same two ranks the second stage
               and the joint step (4 rows of 256² a rank) and the VQGAN (2
               of 512²), the gathered k-means and 2 steps each, ranks bit
               for bit equal, the discriminator's buffer average exact,
               held after the first step to the serial reference (the
               ranks' VQ ids replayed) within DDP_GAN_GAP_LIMIT and a
               planted fault (rank 1's discriminator gradients
               unaveraged) above the discriminator's limit, collectives
               and bytes a step and launches held to the derived counts,
               each rank's peak memory; (b) each through `run_vqwnet`
               under a one-rank NCCL group, 2 steps, and its bare step
               timed with and without the group;
  8i. export — the edit decode exported with `torch.export`
               (`cli/export_model.py`) at the lung model's full widths,
               512²: the f32 decode on the xla route and the bf16 decode on
               the packed route, each traced, saved (`.pt2`) and loaded in
               a fresh process that imports torch and the loader (the
               operator's registration, `ops/conv_pack.py`) and no model
               module; the painted maps decoded there at batch 1 and 8, bit
               for bit the eager `make_batched_edit_fn` on the same maps;
               the packed graph's `medimg::conv3x3_packed` nodes one a
               routed convolution and its `conv3x3_packed:bf16` launches
               those of the eager decodes, none on the xla route; the
               artifact's size, the export's and the load's time, and the
               eager and the artifact's decode times at batch 8;
  8j. doctor — `python -m medical_image_editing_tpu_torch.cli.doctor`
               exits 0 with every check `ok` (started before ckpt_crossing,
               it runs beside that phase and the reference join);
  9. kernels — one line listing every hand-written kernel of the paths
               (the conv kernel's bf16 instance under `conv3x3_packed`, its
               f32 instances as `conv3x3_packed_f32` and
               `conv3x3_packed_tf32`, each with its launches by main path,
               counted under `conv_pack.LAUNCH_KEYS`).
The serve, serve_runtime (its packed route), int8 (b) and (c), train,
f32_step (each variant), trainer, prior (b), second_stage (a) and (b),
multi_window (a) (each mode) and (b), vqgan (a) and (b), losses (a),
(b), (c) and (e), volumetric (a) (each mode) and (b), ddp (a) (each rank
and trainer, counted in its process) and (b) (each run), ckpt_crossing,
export (in the process that serves the artifacts) and the partitioned
services of serve_runtime (d) (each rank, `serve_partition`) phases are
the main paths: each zeroes the launch counts just before it and reads
them just after.
`--only KERNEL` builds one source and runs the device phase and that
kernel's phase alone, with no result line, for holding two checkouts'
versions of a kernel to each other in one call (this script copied into
the other checkout, run from both): `vq`, phase 3 (times and output
hashes); `conv`, hashes of `csrc/conv3x3_packed.cu`'s f32 (`ieee`) and bf16
outputs at the conv points, forward and dx; `int8`, the int8 phase's (a)
(`csrc/conv_s8.cu`'s four kernels bit for bit their plain versions and
timed at the decoder's 25 shapes; a checkout without the weight kernel
folds with its plain version). A
`timing` line after the kernels line gives each phase's seconds; the
card-vs-CPU parts of second_stage, multi_window and vqgan run their CPU
side in a background process and are joined after ckpt_crossing, as is
the prior's.
The last line is `{"ok": true, "device": {...}}`. There is no CPU fallback:
without a CUDA device the script fails at once.
"""

import argparse
import contextlib
import copy
import csv
import gc
import hashlib
import io
import json
import os
import re
import shutil
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
# the VQGAN run's (b) side: the config's 512² in (a), 256² in (b), where
# fifteen fit steps and the test and export passes over 40 slices run
VQGAN_RUN_SIZE = 256
# the resumed VQGAN run against the uninterrupted one
# (`vqgan_run_part.state_gap`) at VQGAN_RUN_SIZE: each limit 5× the largest
# gap of a spread of healthy resumes, rounded up to two digits, at most the
# limit the 512² run held (and that limit where the spread reads 0). The
# spread: three seeds at 256² on an H100 (`tools/vqgan_resume_spread.py`;
# resume; planted fault, the codebook's EMA buffers dropped, smallest): the
# VQGAN's parameters RMS 0.0042-0.0058 lr; 0.053 lr, its Adam moments
# 0.0031-0.0054; 0.058, the discriminator's parameters 0.0021-0.0056 lr;
# 0.012 lr, its moments 0.0033-0.024; 0.029, its spectral-norm vectors
# 5.5e-5-2.0e-4; 2.0e-4, the codebook's embed 2.4e-10-5.0e-10; 1e5, counts
# 0; 0.43, sums 3.4e-4-7.7e-4; 5.4e4 (relative). At 256² the planted fault
# lands above the VQGAN's and the codebook's limits and not always above the
# discriminator's (at 512² it did: 0.023 lr, 0.155, 3.4e-3), so a second
# planted fault drops the discriminator's Adam moments: its parameters 1.256
# lr, moments 3.74, spectral-norm vectors 0.577 (seed 0, H100). The card's f32
# weight gradients are not reproducible run to run, so the resume is not
# held to 0
VQGAN_RESUME_GAP_LIMIT = {
    "decoder": {"params_rms_lr": 0.029, "moments_rel": 0.027},
    "discriminator": {"params_rms_lr": 0.015, "moments_rel": 0.1, "sn_max": 0.00098},
    "codebook": {"embed": 2.5e-9, "cluster_size": 0.01, "embed_avg": 0.0039},
}

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32 outside the
# tensor cores, bf16, TF32 and int8 on the dense tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_INT8_OPS_PER_S = 1979e12

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
# the source's kernel for each instance (`conv_pack.instance`), as the
# profiler names them (each is a template: its instances share the prefix)
CONV_PATHS = {"f32": ("conv3x3_f32_kernel", "cuda-core f32 (ieee)"),
              "tf32": ("conv3x3_tf32_kernel", "mma.sync tf32"),
              "bf16": ("conv3x3_mma_kernel", "mma.sync bf16")}


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


def conv_bound(b, h, w, cin, cout, instance):
    """Least time (ms) for a 3×3 SAME conv on the card, and what bounds it:
    x, the weights and y each moved once (4 bytes an element in f32 and
    TF32, 2 in bf16); 2·B·H·W·9·Cin·Cout operations at the instance's rate:
    f32 on the CUDA cores, or the dense TF32 or bf16 tensor-core rate."""
    size = 2 if instance == "bf16" else 4
    nbytes = size * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
    ops = 2 * b * h * w * 9 * cin * cout
    rate = {"f32": PEAK_F32_FLOP_PER_S, "tf32": PEAK_TF32_FLOP_PER_S,
            "bf16": PEAK_BF16_FLOP_PER_S}[instance]
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
    fewer such kernel launches than calls (it has dropped events) is taken
    again; None ("not measured") after `tries`.
    The names of the kernels counted are added to the list `names`."""
    fn()
    for _ in range(tries):
        _, kernels = profile_window(lambda: [fn() for _ in range(iters)])
        found = [e for e in kernels if match is None or match in e.key]
        us = [device_us(e) for e in found]
        if us and sum(us) > 0 and sum(e.count for e in found) >= iters:
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
    """The 3×3 conv kernel's three instances, forward and dx, each against
    its plain version at each point and at a ragged shape: bf16 and f32
    (ieee) under the run's `ieee`, the TF32 instance under
    `conv_precision("tf32")`; the bf16 serve points. Returns the records."""
    import torch
    import torch.nn.functional as F

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops import conv_pack as tcp
    from medical_image_editing_tpu_torch.ops.conv_pack import (
        conv3x3_packed,
        conv3x3_packed_nchw,
        conv3x3_packed_reference_nchw,
        conv3x3_tf32_reference_nchw,
        flip_transpose,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    b0, cin0, cout0, h0, w0 = CONV_RAGGED
    cases = [(batch, cin, cout, h, h, inst) for cin, cout, h in points
             for inst in ("bf16", "f32", "tf32")]
    cases += [(b, cin, cout, h, h, "bf16") for b, cin, cout, h in CONV_SERVE_POINTS]
    cases += [(b0, cin0, cout0, h0, w0, inst) for inst in ("bf16", "f32", "tf32")]
    records = []
    for b, cin, cout, h, w, inst in cases:
        precision = "tf32" if inst == "tf32" else "ieee"
        dt = torch.bfloat16 if inst == "bf16" else torch.float32
        x = torch.randn(b, cin, h, w, generator=gen, device=device).to(dt)
        wt = ((torch.rand(cout, cin, 3, 3, generator=gen, device=device) * 2 - 1)
              / (9 * cin) ** 0.5).to(dt)
        dy = torch.randn(b, cout, h, w, generator=gen, device=device).to(dt)
        wdx = flip_transpose(wt).contiguous()
        with conv_precision(precision):
            if tcp.instance(dt) != inst:
                raise RuntimeError(f"conv3x3_packed: {precision} picks "
                                   f"{tcp.instance(dt)}, not {inst}")
            before = _build.launches.copy()
            got = conv3x3_packed_nchw(x, wt)
            again = conv3x3_packed_nchw(x, wt)
            dx = conv3x3_packed_nchw(dy, wdx)
            nhwc = conv3x3_packed(x.permute(0, 2, 3, 1).contiguous(),
                                  wt.permute(2, 3, 1, 0).contiguous())
            torch.cuda.synchronize()
            counted = dict(_build.launches - before)
        # the plain versions on the same (rounded) values, TF32 off (the run's
        # ieee); dx through autograd of the forward, not through flip_transpose:
        # for TF32 the gradient of the convolution of x and w rounded to TF32,
        # taken at dy rounded to TF32 (what dx's instance rounds)
        tf32_off()
        rnd = tcp.tf32_round if inst == "tf32" else (lambda t: t)
        xr = rnd(x.float()).requires_grad_()
        ref = F.conv2d(xr, rnd(wt.float()), padding=1)
        ref.backward(rnd(dy.float()))
        ref, ref_dx = ref.detach(), xr.grad
        torch.cuda.synchronize()
        # bf16: one rounding of the f32 sum; f32: sums in another order; TF32:
        # the same rounding, sums in another order (and 2^-10 of the
        # |x|·|w| convolution from the unrounded f32 one)
        rel = {"bf16": 2.0**-8, "f32": 0.0, "tf32": 2.0**-18}[inst]
        fwd_err = float((got.float() - ref).abs().max())
        dx_err = float((dx.float() - ref_dx).abs().max())
        checks = {
            "forward": bool(((got.float() - ref).abs() <= rel * ref.abs() + 1e-4).all()),
            "dx": bool(((dx.float() - ref_dx).abs() <= rel * ref_dx.abs() + 1e-4).all()),
            "deterministic": bool(torch.equal(got, again)),
            "nhwc_entry": bool(torch.equal(nhwc.permute(0, 3, 1, 2), got)),
            "instance_launches": counted == {tcp.KERNEL: 4, tcp.LAUNCH_KEYS[inst]: 4},
        }
        rec = {"phase": "conv", "name": "conv3x3_packed", "instance": inst,
               "dtype": str(dt).split(".")[-1], "precision": precision,
               "path": CONV_PATHS[inst][1], "b": b, "cin": cin, "cout": cout, "h": h,
               "w": w, "forward_max_abs_err": fwd_err, "dx_max_abs_err": dx_err,
               "tolerance": f"|err| <= {rel}*|plain| + 1e-4"}
        if inst == "tf32":  # against the unrounded f32 convolution
            rec["vs_f32_max_abs_err"] = {}
            for name, y, (xx, ww) in (("forward", got, (x, wt)), ("dx", dx, (dy, wdx))):
                err = (y - F.conv2d(xx, ww, padding=1)).abs()
                tol = (2.0**-10 + 2.0**-22) * F.conv2d(xx.abs(), ww.abs(), padding=1) + 1e-4
                checks[f"{name}_vs_f32"] = bool((err <= tol).all())
                rec["vs_f32_max_abs_err"][name] = float(err.max())
            rec["vs_f32_tolerance"] = "(2^-10 + 2^-22) * conv(|x|, |w|) + 1e-4"
        rec["checks"] = checks
        if (b, h, w) != (b0, h0, w0):
            for name, (xx, ww) in (("forward", (x, wt)), ("dx", (dy, wdx))):
                ci, co = ww.shape[1], ww.shape[0]
                bound_ms, bound_by = conv_bound(b, h, w, ci, co, inst)
                seen = []
                with conv_precision(precision):
                    ms = cuda_ms(lambda: conv3x3_packed_nchw(xx, ww), iters=iters)
                    library_ms = cuda_ms(lambda: F.conv2d(xx, ww, padding=1), iters=iters)
                    dev_ms = device_ms(lambda: conv3x3_packed_nchw(xx, ww),
                                       CONV_PATHS[inst][0], names=seen)
                    library_dev_ms = device_ms(lambda: F.conv2d(xx, ww, padding=1))
                plain = (conv3x3_tf32_reference_nchw if inst == "tf32"
                         else conv3x3_packed_reference_nchw)
                rec[name] = {
                    "cin": ci, "cout": co, "ms": ms, "device_ms": dev_ms,
                    "kernel": sorted(set(seen)),
                    "plain_ms": cuda_ms(lambda: plain(xx, ww), iters=iters),
                    "library_ms": library_ms, "vs_library": ms / library_ms,
                    "library_device_ms": library_dev_ms,
                    "vs_library_device": (None if not (dev_ms and library_dev_ms)
                                          else dev_ms / library_dev_ms),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "roofline_share": bound_ms / ms,
                    "roofline_share_device": None if not dev_ms else bound_ms / dev_ms,
                }
                if inst != "bf16":  # cuDNN's f32 in the other precision too
                    other = "ieee" if inst == "tf32" else "tf32"
                    with conv_precision(other):
                        rec[name][f"library_{other}_ms"] = cuda_ms(
                            lambda: F.conv2d(xx, ww, padding=1), iters=iters)
        tf32_off()
        emit(rec)
        if not all(checks.values()):
            raise RuntimeError(f"conv3x3_packed ({inst}) disagrees with its plain version at "
                               f"{(b, cin, cout, h, w)}: {checks}")
        records.append(rec)
    return records


def conv_hash_phase(device, points=CONV_POINTS, batch=8, seed=0):
    """The conv kernel's outputs, forward and dx, at each point and the
    ragged shape, in f32 (under the run's `ieee`: the CUDA-core kernel) and
    bf16, as sha256 prefixes of seeded inputs' outputs. Only the wrapper's
    entries that every version of the port has are called, so this script,
    copied into an older checkout and run from both in one call, holds two
    versions of the kernel to each other: equal hashes, bit-identical
    outputs."""
    import torch

    from medical_image_editing_tpu_torch.ops.conv_pack import conv3x3_packed_nchw, flip_transpose

    tf32_off()
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = [(batch, cin, cout, h, h) for cin, cout, h in points] + [CONV_RAGGED]
    for b, cin, cout, h, w in shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, cin, h, w, generator=gen, device=device).to(dt)
            wt = ((torch.rand(cout, cin, 3, 3, generator=gen, device=device) * 2 - 1)
                  / (9 * cin) ** 0.5).to(dt)
            dy = torch.randn(b, cout, h, w, generator=gen, device=device).to(dt)
            ys = {"forward": conv3x3_packed_nchw(x, wt),
                  "dx": conv3x3_packed_nchw(dy, flip_transpose(wt).contiguous())}
            torch.cuda.synchronize()
            emit({"phase": "conv_hash", "dtype": str(dt).split(".")[-1], "b": b, "cin": cin,
                  "cout": cout, "h": h, "w": w,
                  "sha256": {k: hashlib.sha256(v.float().cpu().numpy().tobytes()).hexdigest()[:16]
                             for k, v in ys.items()}})


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


# --------------------------------------------------------------------------
# the partitioned 2-D edit decode (`edit_batch --partition data|spatial`):
# gloo ranks sharing the card
# --------------------------------------------------------------------------

# (name, mesh (data, spatial), partition, mode): the 2 × 2 runs on four
# ranks, the rest on ranks 0 and 1
EDIT_PART_RUNS = (
    ("spatial_2x2_f32", (2, 2), "spatial", "f32"),
    ("spatial_2x2_bf16_packed", (2, 2), "spatial", "bf16_packed"),
    ("data_2x1_f32", (2, 1), "data", "f32"),
    ("data_2x1_bf16_packed", (2, 1), "data", "bf16_packed"),
    ("spatial_1x2_f32", (1, 2), "spatial", "f32"),
    ("spatial_1x2_bf16_packed", (1, 2), "spatial", "bf16_packed"),
    ("spatial_1x2_int8", (1, 2), "spatial", "int8"),
)
# mode: (compute dtype, MEDIMG_CONV_IMPL, quantize)
EDIT_PART_MODES = {"f32": (None, "xla", None), "bf16_packed": ("bfloat16", "packed", None),
                   "int8": (None, "xla", "int8")}
# Each mode's limits on a run's largest and mean gaps to the one-process
# card decode of the same maps are EDIT_PART_LIMIT_FACTOR × the largest of
# the one-process decode's perturbed at the rounding level (the decoder's
# input and every instance norm's output, where the sharded decode's sums
# differ, moved by one ulp of their dtype, `edit_part_nudged`, at each seed
# of EDIT_PART_SPREAD), at least EDIT_PART_LIMIT_MIN. int8 is held by its
# mean gap only: a rounding-level change turns an int8 code at a near-tie
# here and there, and the instance norms carry it on, so its largest gap is
# a heavy tail that three readings do not bound. Those limits are loose in
# bf16 and int8, so each convolution of those decodes that the kernels run
# (every one in int8, the packed ones in bf16) is held bit for bit besides,
# on the halo'd row blocks the sharded decode gives it
# (`edit_part_conv_check`). The planted fault (every halo exchange
# returning zeros) must land EDIT_PART_FAULT_MARGIN × above the f32 limit
# of the largest gap. Rank 0 times its decodes of EDIT_PART_PROFILED under
# the profiler (their times, and the other ranks' waiting for it, include
# it).
EDIT_PART_SPREAD = (1, 2, 3)
EDIT_PART_LIMIT_FACTOR = 5.0
EDIT_PART_LIMIT_MIN = 1e-6
EDIT_PART_FAULT_MARGIN = 10.0
EDIT_PART_GO_TIMEOUT_S = 600
EDIT_PART_PROFILED = ("spatial_2x2_f32", "spatial_2x2_bf16_packed")


@contextlib.contextmanager
def cli_lung_widths(model):
    """`run_recon.LungConfig` (the config `edit_batch.main` builds) at
    `model`'s widths inside the block, restored after."""
    from medical_image_editing_tpu_torch.cli import run_recon

    cfg = lung_config(model)
    keys = ("in_channels", "enc_filters", "dec_filters", "dict_size", "knn_backend",
            "use_pixel_shuffle", "dropped_skip_layers")
    prev = {k: getattr(run_recon.LungConfig, k) for k in keys}
    for k in keys:
        setattr(run_recon.LungConfig, k, getattr(cfg, k))
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(run_recon.LungConfig, k, v)


def edit_part_models(model, device, seed):
    """The lung decoder at `model` widths in each mode's compute dtype (one
    module for the f32 and int8 modes), with the serve phase's seeded
    weights, and the codebook → ({mode: decoder}, vq_state, dataset
    window)."""
    import torch

    from medical_image_editing_tpu_torch.cli.run_recon import load_model
    from medical_image_editing_tpu_torch.models.blocks import set_compute_dtype

    cfg = lung_config(model)
    _, dec, vq = load_model(cfg, device=device, seed=seed)
    decoders = {}
    for mode, (dtype, _, _) in EDIT_PART_MODES.items():
        if dtype is None:
            decoders[mode] = dec
        else:
            decoders[mode] = copy.deepcopy(dec)
            decoders[mode].compute_dtype = getattr(torch, dtype)
            set_compute_dtype(decoders[mode], getattr(torch, dtype))
    window = (cfg.window_width, cfg.window_center, cfg.window_scale)
    return decoders, vq, window


def decoder_layers(decoder, shape):
    """Each convolution of an unsharded forward of `decoder` on `shape`
    (NCHW): (kernel rows, row reach, input shape), and the instance norms'
    input shapes, in call order (meta tensors)."""
    import torch

    from medical_image_editing_tpu_torch.models import blocks

    meta = copy.deepcopy(decoder).to("meta").eval()
    convs, norms = [], []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: convs.append((m.kernel_size[0], m.padding[0], tuple(a[0].shape))))
        for m in meta.modules() if isinstance(m, blocks.Conv)]
    real = blocks.instance_norm

    def norm(x, eps=1e-5, mesh=None):
        norms.append(tuple(x.shape))
        return real(x, eps, mesh)

    blocks.instance_norm = norm
    try:
        with torch.no_grad():
            meta(torch.zeros(shape, device="meta"))
    finally:
        blocks.instance_norm = real
        for h in hooks:
            h.remove()
    return convs, norms


def edit_part_expected(decoder, channels, mesh, coords, batch, size, mode):
    """Collectives and bytes one rank issues for one decode of `batch`
    global maps of `size`² on a `mesh` (data, spatial) at `coords`,
    derived from the decoder's layers: the label check (one all-reduce of
    two int64 over the mesh); under "spatial" the mask count (one
    all-reduce of the rank's per-map f32 counts), two all-reduces an
    instance norm ((B, C) f32 sums each) and one halo exchange a
    convolution taller than one row, a message each way to each rank
    within its reach (`hop_rows`) that exists, in the compute dtype (f32
    under int8); under int8 one MAX all-reduce of each convolution's (Cin,)
    f32 maxima."""
    import collections

    from medical_image_editing_tpu_torch.parallel.spatial import hop_rows

    d, s = mesh
    b = batch // d
    out = collections.Counter({"all_reduce": 1, "all_reduce_bytes": 16})
    if s == 1:
        return dict(out)
    convs, norms = decoder_layers(decoder, (b, channels, size, size))
    elem = 2 if EDIT_PART_MODES[mode][0] == "bfloat16" else 4
    out["all_reduce"] += 1 + 2 * len(norms)
    out["all_reduce_bytes"] += 4 * b + sum(2 * 4 * n * c for n, c, *_ in norms)
    for k_rows, reach, (n, c, h, w) in convs:
        if mode == "int8":
            out["all_reduce"] += 1
            out["all_reduce_bytes"] += 4 * c
        if k_rows == 1:
            continue
        for k, rows in enumerate(hop_rows(h // s, reach), 1):
            for peer in (coords[1] - k, coords[1] + k):
                if 0 <= peer < s:
                    for kind in ("send", "recv"):
                        out[kind] += 1
                        out[kind + "_bytes"] += elem * n * c * rows * w
    return dict(out)


@contextlib.contextmanager
def edit_part_nudged(seed, decoder):
    """Inside the block `decoder`'s forward is perturbed at the rounding
    level: its input moves by one ulp of its compute dtype and each
    instance norm's output by one ulp of its dtype, each element up or
    down at random (a generator seeded with `seed`)."""
    import torch

    from medical_image_editing_tpu_torch.models import blocks

    real, gens = blocks.instance_norm, {}

    def gen(device):
        return gens.setdefault(device, torch.Generator(device=device).manual_seed(seed))

    def nudged(x, eps=1e-5, mesh=None):
        y = real(x, eps, mesh)
        return ulp_nudge(y, gen(y.device))

    hook = decoder.register_forward_pre_hook(
        lambda m, args: (ulp_nudge(args[0], gen(args[0].device), m.compute_dtype),))
    blocks.instance_norm = nudged
    try:
        yield
    finally:
        blocks.instance_norm = real
        hook.remove()


def edit_part_decode(decoders, vq, ids, window, mode, device, *, mesh=None, partition="data",
                     nudge=None, timed=False, profiled=False):
    """`mode`'s decode of `ids` (this rank's block under `mesh`), perturbed at
    the rounding level with `nudge` (a seed): the output on the host (f32),
    the collectives and kernel launches of that decode, its time on the host
    clock (synchronised) and the peak memory. `timed`: the time is a second
    decode's (the first at a mesh's shapes takes cuDNN's and the
    allocator's first calls), `profiled` that one under torch.profiler, with
    the device's busy and idle share."""
    import collections

    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh as pmesh

    cuda = torch.device(device).type == "cuda"
    dtype, impl, quantize = EDIT_PART_MODES[mode]
    dec = decoders[mode]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with contextlib.nullcontext() if nudge is None else edit_part_nudged(nudge, dec):
        with conv_route(impl):
            edit = make_batched_edit_fn(dec, is_lung=True, dataset_window=window, mesh=mesh,
                                        partition=partition, quantize=quantize, device=device)
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            coll, kern = collections.Counter(pmesh.collectives), collections.Counter(
                _build.launches)
            t0 = time.perf_counter()
            out = edit(vq, ids)
            sync()
            rec = {"decode_s": time.perf_counter() - t0,
                   "collectives": dict(collections.Counter(pmesh.collectives) - coll),
                   "launches": dict(collections.Counter(_build.launches) - kern)}
            rec["out"] = out.float().cpu().numpy()
            if profiled:
                rec["decode_s"], kernels = profile_window(lambda: edit(vq, ids))
                rec["profile"] = kernel_breakdown(rec["decode_s"], kernels)
            elif timed:
                t0 = time.perf_counter()
                edit(vq, ids)
                sync()
                rec["decode_s"] = time.perf_counter() - t0
            rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    return rec


def edit_part_conv_check(decoders, vq, ids, window, mode, device, mesh):
    """One decode of `ids` (this rank's block) in `mode` on the spatial
    `mesh`, each convolution held where it runs (bf16 on the packed route:
    each one the packed kernel takes; int8: every one): its input block
    gathered over this rank's row of the mesh, the same module unsharded on
    it (the packed kernel at the whole map's height; the s8 kernels with the
    whole maps' scales), and this rank's rows of that against the sharded
    output. Off the counted launches. → {"convs": how many were held,
    "max_abs": their largest gap (0: bit for bit), "within_ulp": whether
    every gap is within one ulp of the output (2^-7·|unsharded| + 1e-4,
    bf16's; on the CPU the packed route runs PyTorch's convolution, whose
    sums are not those of another height), "heights": the rows of the
    halo'd blocks the sharded calls ran on}."""
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.models.blocks import Conv
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel.mesh import VolumetricMesh

    _, impl, quantize = EDIT_PART_MODES[mode]
    dec = decoders[mode]
    row = VolumetricMesh(1, mesh.spatial, mesh.coords[1], world_group=mesh.spatial_group)
    held = {"convs": 0, "max_abs": 0.0, "within_ulp": True, "heights": set()}

    def hold(m, args, y):
        x = args[0]
        if quantize is None and not m.routes_to_kernel(x):
            return
        whole = row.gather(x, depth_axis=2)
        m.mesh = None
        try:
            want = row.block(m.forward(whole), depth_axis=2)
        finally:
            m.mesh = mesh
        held["convs"] += 1
        gap, want = (y.float() - want.float()).abs(), want.float()
        held["max_abs"] = max(held["max_abs"], float(gap.max()))
        held["within_ulp"] &= bool((gap <= 2.0**-7 * want.abs() + 1e-4).all())
        held["heights"].add(x.shape[2] + (2 * m.padding[0] if m.kernel_size[0] > 1 else 0))

    counted = _build.launches.copy()
    hooks = [m.register_forward_hook(hold) for m in dec.modules() if isinstance(m, Conv)]
    try:
        with conv_route(impl):
            make_batched_edit_fn(dec, is_lung=True, dataset_window=window, mesh=mesh,
                                 partition="spatial", quantize=quantize, device=device)(vq, ids)
    finally:
        for h in hooks:
            h.remove()
        _build.launches.clear()
        _build.launches.update(counted)
    held["heights"] = sorted(held["heights"])
    return held


# the partitioned services on ranks 0 and 1 (`serve_part_rank`): (name, mesh
# (data, spatial), partition, mode of EDIT_PART_MODES) of each HTTP service
SERVE_PART_RUNS = (
    ("spatial_1x2_bf16_packed", (1, 2), "spatial", "bf16_packed"),
    ("data_2x1_f32", (2, 1), "data", "f32"),
)
SERVE_PART_STOP_S = 10.0  # a follower returns within this of rank 0's stop


def serve_part_http(rank, mesh, partition, mode, model, seed, device, painted):
    """One partitioned HTTP service of `serve_part_rank`, through
    `serve_http.serve` on both ranks: rank 0 serves a local port from a
    thread, to a client of its own (the painted batch, one map, under
    "data" three maps, a PNG, a label past the codebook, a map 8 columns
    short (which the decoder's poolings do not divide), a good request,
    the batch and the map again), then shuts the server down (`serve` sends
    stop); rank 1 follows. Rank 0 → each request's status, answer, client
    wall time and X-Edit-Ms; both → the time (wall clock) rank 0 shut the
    server down or rank 1 returned, and the kernel launches."""
    import queue
    import threading
    import urllib.error
    import urllib.request

    from medical_image_editing_tpu_torch.cli.serve_http import serve
    from medical_image_editing_tpu_torch.ops import _build

    dtype, impl, _ = EDIT_PART_MODES[mode]
    cfg = lung_config(model)
    cfg.compute_dtype = dtype
    out = {}
    kw = dict(port=0, warm_shapes=(), partition=partition, device=device, mesh=mesh, seed=seed)
    with conv_route(impl), contextlib.redirect_stdout(io.StringIO()):
        _build.launches.clear()
        if rank > 0:
            out["followed"] = dict(serve(cfg, **kw))
            out["ended_at"] = time.time()
            out["launches"] = dict(_build.launches)
            return out
        started, failed = queue.Queue(), []

        def run():
            try:
                serve(cfg, started=started.put, **kw)
            except BaseException as e:
                failed.append(e)
                started.put(None)

        thread = threading.Thread(target=run, daemon=True, name="serve-http")
        thread.start()
        httpd = started.get(timeout=600)
        if httpd is None:
            raise RuntimeError("serve_http.serve ended before it served") from failed[0]
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        bad = painted[0].copy()
        bad[0, 0] = cfg.dict_size + 1
        requests = [("healthz", "/healthz", None), ("batch", "/edit", painted),
                    ("one", "/edit", painted[0])]
        if partition == "data":
            requests.append(("three", "/edit", painted[:3]))
        # then the batch and the map again: warm readouts (the first calls at
        # a shape build cuDNN's plans on the dispatch thread)
        requests += [("png", "/edit?format=png", painted[0]), ("bad_label", "/edit", bad),
                     ("bad_shape", "/edit", painted[0][:, :-8]),
                     ("after_bad", "/edit", painted[0]), ("batch_warm", "/edit", painted),
                     ("one_warm", "/edit", painted[0])]
        out["requests"] = []
        try:
            for name, path, maps in requests:
                body = None
                if maps is not None:
                    buf = io.BytesIO()
                    np.save(buf, maps)
                    body = buf.getvalue()
                req = urllib.request.Request(url + path, data=body,
                                             method="GET" if body is None else "POST")
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        code, data, edit_ms = r.status, r.read(), r.headers.get("X-Edit-Ms")
                except urllib.error.HTTPError as e:
                    code, data, edit_ms = e.code, e.read(), None
                host_ms = (time.perf_counter() - t0) * 1e3
                if path == "/healthz":
                    answer = json.loads(data)
                elif code == 200 and "png" not in path:
                    answer = np.load(io.BytesIO(data))
                else:
                    answer = data
                out["requests"].append({"name": name, "path": path, "status": code,
                                        "maps": None if maps is None else list(maps.shape),
                                        "host_ms": host_ms,
                                        "x_edit_ms": None if edit_ms is None else float(edit_ms),
                                        "answer": answer})
        finally:
            out["ended_at"] = time.time()  # then `serve` closes the server and sends stop
            httpd.shutdown()
            thread.join(timeout=60)
        if failed:
            raise failed[0]
        if thread.is_alive():
            raise RuntimeError("serve_http.serve still running 60 s after its server's shutdown")
        out["launches"] = dict(_build.launches)
    return out


def serve_part_recon(rank, rows, model, seed, device, painted, work):
    """`run_recon.serve` with `config.partition = "spatial"` (f32, the xla
    route) on the 1 × 2 mesh `rows`: rank 0 watches a NIfTI of the first
    painted map for two passes (one Processing, one Skip), rank 1 follows.
    → rank 0's stdout and recon (caught from `process_edit`), the files
    each rank wrote, the launches, the time the loop ended."""
    from medical_image_editing_tpu_torch.cli import run_recon
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti

    cfg = lung_config(model)
    cfg.compute_dtype = None
    cfg.partition = "spatial"
    here = work / f"watch-{rank}"
    here.mkdir()
    cfg.edited_file_path = str(work / "watch_label.nii.gz")
    cfg.save_dir_path = str(here / "inference")
    if rank == 0:
        nifti.save(nifti.to_nifti_array(painted[0]), cfg.edited_file_path, dtype=np.int32)
    real, recons = run_recon.process_edit, []

    def caught(*args, **kw):
        edited = real(*args, **kw)
        recons.append(edited[0])
        return edited

    log = io.StringIO()
    run_recon.process_edit = caught
    _build.launches.clear()
    try:
        with conv_route("xla"), contextlib.redirect_stdout(log):
            run_recon.serve(cfg, poll_seconds=0.2, max_iters=2, watch="poll", device=device,
                            mesh=rows)
    finally:
        run_recon.process_edit = real
    return {"stdout": log.getvalue(), "recons": recons, "ended_at": time.time(),
            "written": sorted(str(f.relative_to(here)) for f in here.rglob("*") if f.is_file()),
            "launches": dict(_build.launches)}


def serve_part_rank(rank, model, seed, device, painted, work):
    """Ranks 0 and 1 of the edit partition part, after its decodes: the
    partitioned HTTP services of SERVE_PART_RUNS, then the partitioned
    file-watching loop (`serve_part_recon`) → their records, the launches
    of all of them and the seconds they took."""
    from medical_image_editing_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    out, launches = {}, {}
    for name, shape, partition, mode in SERVE_PART_RUNS:
        out[name] = serve_part_http(rank, pmesh.create_volumetric_mesh(*shape), partition, mode,
                                    model, seed, device, painted)
    out["recon"] = serve_part_recon(rank, pmesh.create_volumetric_mesh(1, 2), model, seed,
                                    device, painted, work)
    for rec in out.values():
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def edit_part_rank(rank, world, init_file, workdir, model, seed, device, cli_argv):
    """One rank of the partitioned decode, in a process of its own: a gloo
    group (NCCL refuses several ranks on one card) through `init_file`;
    once the parent writes `workdir/go`, the 2 × 2 runs of EDIT_PART_RUNS on
    all four ranks, then ranks 0 and 1 in a group of their own take the
    other runs (each decoded twice: counted, then timed; rank 0 times its
    decodes of EDIT_PART_PROFILED under the profiler: the device's idle
    share), the planted fault (zero halos, 1 × 2, f32) and
    `edit_batch --partition spatial`, then the partitioned services
    (`serve_part_rank`, their launches counted apart). After each spatial
    run in bf16 or int8 a decode of one map a data block holds its
    convolutions (`edit_part_conv_check`). Saves its records to
    `workdir/edit-part-RANK.pt`."""
    import torch
    import torch.distributed as dist

    from medical_image_editing_tpu_torch.cli import edit_batch
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh as pmesh
    from medical_image_editing_tpu_torch.utils.device import apply_conv_precision

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        # a share of the card each, the parent's the same: cuDNN's f32
        # convolutions then take algorithms whose workspace fits it
        torch.cuda.set_per_process_memory_fraction(1.0 / (world + 1))
    else:  # several ranks' OpenMP pools on one host spin against each other
        torch.set_num_threads(1)
    os.environ["MEDIMG_CONV_PRECISION"] = "ieee"
    apply_conv_precision()
    work = Path(workdir)
    painted = np.load(work / "painted.npy")
    decoders, vq, window = edit_part_models(model, device, seed)
    # each mode's first decode (the libraries' and cuDNN's first calls; on
    # rank 0 the profiler's start-up) on a corner of one map, while the
    # parent holds the card: off the measured decodes and the counted launches
    for mode in EDIT_PART_MODES:
        edit_part_decode(decoders, vq, painted[:1, :64, :64], window, mode, device,
                         profiled=cuda and rank == 0)
    _build.launches.clear()
    out = {"runs": {}, "conv_checks": {}, "rank": rank}

    def runs(meshes):
        for name, shape, partition, mode in EDIT_PART_RUNS:
            if shape in meshes:
                mesh = meshes[shape]
                out["runs"][name] = edit_part_decode(
                    decoders, vq, mesh.block(painted), window, mode, device, mesh=mesh,
                    partition=partition, timed=True,
                    profiled=cuda and rank == 0 and name in EDIT_PART_PROFILED)
                if partition == "spatial" and mode != "f32":
                    out["conv_checks"][name] = edit_part_conv_check(
                        decoders, vq, mesh.block(painted[:mesh.data]), window, mode, device,
                        mesh)
                if cuda:
                    torch.cuda.empty_cache()

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        go, t0 = work / "go", time.monotonic()
        while not go.exists():  # the card is the parent's until it writes `go`
            if time.monotonic() - t0 > EDIT_PART_GO_TIMEOUT_S:
                raise RuntimeError(f"no {go} after {EDIT_PART_GO_TIMEOUT_S} s")
            time.sleep(0.05)
        runs({(2, 2): pmesh.create_volumetric_mesh(2, 2)})
    finally:
        dist.destroy_process_group()
    if rank < 2:
        # made by the port: its services read the group's timeout
        pmesh.init_process_group("gloo", f"file://{init_file}.two", rank, 2)
        try:
            rows = pmesh.create_volumetric_mesh(1, 2)
            runs({(2, 1): pmesh.create_volumetric_mesh(2, 1), (1, 2): rows})
            with zero_halos():
                out["fault"] = edit_part_decode(decoders, vq, rows.block(painted), window, "f32",
                                                device, mesh=rows, partition="spatial")["out"]
            t0 = time.perf_counter()
            with cli_lung_widths(model), contextlib.redirect_stdout(io.StringIO()):
                rc = edit_batch.main(cli_argv + ["--partition", "spatial", "--out-dir",
                                                 str(work / "cli_spatial")])
            if rc != 0:
                raise RuntimeError(f"edit_batch --partition spatial: rc {rc}")
            out["cli_s"] = time.perf_counter() - t0
            out["launches"] = dict(_build.launches)
            out["services"] = serve_part_rank(rank, model, seed, device, painted, work)
        finally:
            dist.destroy_process_group()
    else:
        out["launches"] = dict(_build.launches)
    torch.save(out, work / f"edit-part-{rank}.pt")


def assemble(blocks, mesh):
    """The global (B, H, W) array from the ranks' blocks of a (data, spatial)
    mesh, in rank order."""
    d, s = mesh
    return np.concatenate([np.concatenate(blocks[i * s:(i + 1) * s], 1) for i in range(d)], 0)


def serve_part_checks(ranks, refs, serve_refs, limits, routed, painted, cuda):
    """The record of the partitioned services (`serve_part_rank` on ranks 0
    and 1): each answer held to the one-process card decode of the same
    maps (`refs` for the painted batch, `serve_refs` for one and three
    maps) within its mode's limits (the largest and the mean gap), the
    statuses (the label past the codebook and the map 8 columns short 400,
    the next request 200), the
    3-map request padded under "data" and answered with 3, the PNG's
    signature and size, every rank's decodes of the same requests, rank
    1's return within SERVE_PART_STOP_S of rank 0's stop, the packed
    kernel's launches `routed` a rank a decode in bf16 (0 in f32) and the
    VQ kernel's 0; the file-watching loop's one Processing and one Skip,
    its recon within the f32 limits, PNGs from rank 0 only."""
    from medical_image_editing_tpu_torch.utils.imaging import PNG_SIGNATURE

    size = int(painted.shape[-1])
    svc = [r["services"] for r in ranks[:2]]
    held = ("max_abs_err", "mean_abs_err")
    rec = {"phase": "serve_runtime", "part": "serve_partition", "backend": "gloo",
           "ranks": 2, "size": size, "batch": int(painted.shape[0]), "runs": {}, "checks": {},
           "seconds": [s["seconds"] for s in svc],
           "readout_note": "gloo ranks sharing one card; no figure for cards joined by NVLink"}
    want = {"batch": lambda mode: refs[mode]["out"],
            "one": lambda mode: serve_refs[(mode, 1)][0],
            "after_bad": lambda mode: serve_refs[(mode, 1)][0],
            "three": lambda mode: serve_refs[(mode, 3)],
            "batch_warm": lambda mode: refs[mode]["out"],
            "one_warm": lambda mode: serve_refs[(mode, 1)][0]}
    for name, shape, partition, mode in SERVE_PART_RUNS:
        r0, r1 = svc[0][name], svc[1][name]
        by_name = {q["name"]: q for q in r0["requests"]}
        gaps = {q: decode_gap(by_name[q]["answer"], want[q](mode)) for q in want
                if q in by_name}
        decodes = r1["followed"].get("edit", 0)
        per_rank = {"conv3x3_packed": routed * decodes if mode == "bf16_packed" and cuda else 0,
                    "vq_fused": 0}
        png = by_name["png"]["answer"]
        statuses = {q["name"]: q["status"] for q in r0["requests"]}
        rec["runs"][name] = {
            "mesh": list(shape), "partition": partition, "mode": mode, "gap": gaps,
            "limit": limits[mode], "statuses": statuses,
            "shapes": {q: list(np.shape(by_name[q]["answer"])) for q in gaps},
            "decodes_per_rank": decodes, "followed": r1["followed"],
            "launches_per_rank": [s[name]["launches"] for s in svc],
            "launches_expected_per_rank": per_rank,
            "stop_to_return_s": r1["ended_at"] - r0["ended_at"],
            "healthz": by_name["healthz"]["answer"],
            "readouts": [{k: q[k] for k in ("name", "maps", "status", "host_ms", "x_edit_ms")}
                         for q in r0["requests"]]}
        want_shapes = {"batch": list(painted.shape), "one": [size, size],
                       "after_bad": [size, size], "three": [3, size, size],
                       "batch_warm": list(painted.shape), "one_warm": [size, size]}
        rec["checks"][name] = {
            "within": all(np.isfinite(by_name[q]["answer"]).all()
                          and g[k] <= limits[mode][k] for q, g in gaps.items() for k in held),
            "shapes": all(rec["runs"][name]["shapes"][q] == want_shapes[q] for q in gaps),
            # 3 maps split over 2 ranks only once padded to 4
            "three_padded": partition != "data"
            or rec["runs"][name]["shapes"].get("three") == [3, size, size],
            "statuses": statuses["bad_label"] == statuses["bad_shape"] == 400
            and statuses["after_bad"] == 200
            and all(v == 200 for q, v in statuses.items() if q not in ("bad_label", "bad_shape")),
            "png": png[:8] == PNG_SIGNATURE
            and int.from_bytes(png[16:20], "big") == int.from_bytes(png[20:24], "big") == size,
            "healthz": by_name["healthz"]["answer"].get("partition") == partition,
            "followers_decoded_each": decodes == sum(
                1 for q in r0["requests"] if q["path"] != "/healthz" and q["status"] == 200)
            and r1["followed"].get("stop") == 1,
            "followers_ended": 0 <= rec["runs"][name]["stop_to_return_s"] < SERVE_PART_STOP_S,
            "launches": all({k: s[name]["launches"].get(k, 0) for k in per_rank} == per_rank
                            for s in svc)
            and (mode != "bf16_packed" or not cuda or routed > 0)}
    r0, r1 = svc[0]["recon"], svc[1]["recon"]
    gap = decode_gap(np.stack(r0["recons"]), serve_refs[("f32", 1)]) if r0["recons"] else None
    rec["runs"]["recon_serve"] = {"mesh": [1, 2], "partition": "spatial", "mode": "f32",
                                  "gap": gap, "limit": limits["f32"], "written": [
                                      r0["written"], r1["written"]],
                                  "launches_per_rank": [r0["launches"], r1["launches"]],
                                  "stop_to_return_s": r1["ended_at"] - r0["ended_at"]}
    rec["checks"]["recon_serve"] = {
        "processing_skip": (r0["stdout"].count("Processing..."), r0["stdout"].count("Skip..."))
        == (1, 1),
        "within": gap is not None and all(gap[k] <= limits["f32"][k] for k in held),
        "rank0_pngs_only": len(r0["written"]) == 2 and not r1["written"]
        and all(f.endswith(".png") for f in r0["written"]),
        # rank 0's time is taken once its loop has sent stop and returned
        "followers_ended": abs(rec["runs"]["recon_serve"]["stop_to_return_s"])
        < SERVE_PART_STOP_S,
        "launches": all(not n.get("conv3x3_packed") and not n.get("vq_fused")
                        for n in (r0["launches"], r1["launches"]))}
    launches = {}
    for s in svc:
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec["launches"] = launches
    return rec


def edit_partition_part(device, model, painted, workdir, *, seed=0, timeout=600):
    """The partitioned edit decode (`make_batched_edit_fn(mesh=,
    partition=)`, `edit_batch --partition`) at `model` widths on the serve
    phase's painted maps, on gloo ranks sharing the card: the runs of
    EDIT_PART_RUNS (data on 2 ranks; spatial on 1 × 2 and 2 × 2; f32 on the
    xla route, bf16 on the packed route, int8 on 1 × 2), each held to the
    one-process card decode of the same maps within its mode's limit from
    a spread of ulp-nudged one-process decodes (EDIT_PART_SPREAD); the
    zero-halo fault above the f32 limit by EDIT_PART_FAULT_MARGIN; every
    rank's collectives and bytes a decode equal to `edit_part_expected`;
    the packed kernel's launches a rank a decode equal to the convolutions
    the model routes (> 0 in bf16, 0 in f32), and under int8 each s8
    kernel's to the convolutions; in the bf16 and int8 spatial runs each
    convolution the kernels run bit for bit the unsharded one on the
    gathered input (`edit_part_conv_check`, one map a data block);
    `edit_batch --partition spatial` on two
    ranks against `--partition none`, and under a one-rank group that the
    CLI makes from a torchrun environment (NCCL on the card) bit for bit
    none. Then on ranks 0 and 1 the partitioned services
    (`serve_part_rank`, checked by `serve_part_checks`: `serve_http` on
    1 × 2 "spatial" in bf16 on the packed route and 2 × 1 "data" in f32,
    `run_recon.serve` on 1 × 2 "spatial" in f32). Readouts: a rank's decode
    time and peak memory beside the one-process decode's, rank 0's device
    idle share, the services' X-Edit-Ms and client wall times. Returns the
    ranks' launches of the partitioned decodes and, apart, of the
    services."""
    import torch

    from medical_image_editing_tpu_torch.cli import edit_batch
    from medical_image_editing_tpu_torch.parallel import mesh as pmesh
    from medical_image_editing_tpu_torch.utils import nifti

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir) / "edit_partition"
    labels = work / "labels"
    labels.mkdir(parents=True)
    np.save(work / "painted.npy", painted)
    for i, m in enumerate(painted):
        nifti.save(nifti.to_nifti_array(m), str(labels / f"label_{i:04d}.nii.gz"),
                   dtype=np.int32)
    batch, size = int(painted.shape[0]), int(painted.shape[-1])
    cli_argv = ["--label-dir", str(labels), "--batch-size", str(batch),
                *([] if cuda else ["--device", "cpu"])]
    # the ranks start (imports, CUDA, the seeded models) while this process
    # takes the one-process decodes, the spread and the CLI runs on the
    # card; they decode once it writes `go`
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=edit_part_rank, args=(r, 4, str(work / "init"), str(work), model,
                                                      seed, device, cli_argv))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        with conv_precision("ieee"):
            decoders, vq, window = edit_part_models(model, device, seed)
            nudged = {mode: [edit_part_decode(decoders, vq, painted, window, mode, device,
                                              nudge=s)["out"] for s in EDIT_PART_SPREAD]
                      for mode in EDIT_PART_MODES}
            # after the nudged decodes, so that their times are warm, as the ranks' are
            refs = {mode: edit_part_decode(decoders, vq, painted, window, mode, device)
                    for mode in EDIT_PART_MODES}
            spread = {mode: [decode_gap(o, refs[mode]["out"]) for o in nudged[mode]]
                      for mode in EDIT_PART_MODES}
            # the services' other requests: one map (both modes), three (f32)
            serve_refs = {(mode, n): edit_part_decode(decoders, vq, painted[:n], window, mode,
                                                      device)["out"]
                          for mode, n in (("f32", 1), ("bf16_packed", 1), ("f32", 3))}
            emb = int(model["enc_filters"][0])
            with conv_route("packed"):
                routed = routed_convs(decoders["bf16_packed"], torch.zeros(1, emb, size, size))
            n_convs = len(decoder_layers(decoders["f32"], (1, emb, size, size))[0])
            expected = {name: [edit_part_expected(decoders[mode], emb, shape,
                                                  (r // shape[1], r % shape[1]), batch, size,
                                                  mode)
                               for r in range(shape[0] * shape[1])]
                        for name, shape, _, mode in EDIT_PART_RUNS}
            del decoders
            env = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost",
                       MASTER_PORT=free_port())
            cli_s = {}
            with cli_lung_widths(model), contextlib.redirect_stdout(io.StringIO()):
                for name, extra, ctx_env in (("none", [], {}),
                                             ("one_rank", ["--partition", "spatial"], env)):
                    t0 = time.perf_counter()
                    with torchrun_env(**ctx_env):
                        rc = edit_batch.main(cli_argv + extra + ["--out-dir",
                                                                 str(work / f"cli_{name}")])
                    cli_s[name] = time.perf_counter() - t0
                    if rc != 0 or pmesh.is_active():
                        raise RuntimeError(f"edit_batch {name}: rc {rc}, group left "
                                           f"{pmesh.is_active()}")
            tf32_off()
        if cuda:  # the card's memory the ranks' (this process's cache included)
            gc.collect()
            torch.cuda.empty_cache()
        (work / "go").touch()
        t0 = time.perf_counter()
    finally:
        ranks = join_ranks(work, procs, timeout, "edit partition", "edit-part")
    ranks_s = time.perf_counter() - t0
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v

    held = ("max_abs_err", "mean_abs_err")
    limits = {mode: {k: max(EDIT_PART_LIMIT_MIN,
                            EDIT_PART_LIMIT_FACTOR * max(g[k] for g in spread[mode]))
                     for k in held} for mode in EDIT_PART_MODES}
    runs, checks = {}, {}
    for name, shape, partition, mode in EDIT_PART_RUNS:
        parts = [r["runs"][name] for r in ranks[:shape[0] * shape[1]]]
        out = assemble([p["out"] for p in parts], shape)
        per_decode = {"conv3x3_packed": routed if mode == "bf16_packed" else 0,
                      **{k: n_convs if mode == "int8" else 0 for k in S8_KERNELS}}
        if not cuda:
            per_decode = {k: 0 for k in per_decode}
        got_launches = [{k: p["launches"].get(k, 0) for k in per_decode} for p in parts]
        runs[name] = {"mesh": list(shape), "partition": partition, "mode": mode,
                      "gap": decode_gap(out, refs[mode]["out"]), "limit": limits[mode],
                      "collectives": parts[0]["collectives"],
                      "collectives_expected": expected[name][0],
                      "launches_per_decode": got_launches[0],
                      "decode_s": [p["decode_s"] for p in parts],
                      "profiled_on_rank0": "profile" in parts[0],
                      "peak_bytes": [p["peak_bytes"] for p in parts]}
        checks[name] = {
            "within": bool(np.isfinite(out).all())
            and all(runs[name]["gap"][k] <= limits[mode][k]
                    for k in (held[1:] if mode == "int8" else held)),
            "collectives": all(p["collectives"] == e for p, e in zip(parts, expected[name])),
            "launches": all(g == per_decode for g in got_launches)
            and (mode != "bf16_packed" or not cuda or routed > 0)}
    fault = assemble([r["fault"] for r in ranks[:2]], (1, 2))
    fault_gap = decode_gap(fault, refs["f32"]["out"])
    fault_margin = {k: fault_gap[k] / limits["f32"][k] for k in held}
    cli_gap = {}
    for name in ("spatial", "one_rank"):
        files = sorted(os.listdir(work / "cli_none"))
        got = [nifti.load(str(work / f"cli_{name}" / f)) for f in files]
        want = [nifti.load(str(work / "cli_none" / f)) for f in files]
        cli_gap[name] = {"files": len(files), "max_abs": max(
            float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(got, want))}
    conv_checks = {}
    for name, shape, _, mode in EDIT_PART_RUNS:
        if name in ranks[0]["conv_checks"]:
            parts = [r["conv_checks"][name] for r in ranks[:shape[0] * shape[1]]]
            conv_checks[name] = {"convs": [p["convs"] for p in parts],
                                 "max_abs": max(p["max_abs"] for p in parts),
                                 "within_ulp": all(p["within_ulp"] for p in parts),
                                 "heights": parts[0]["heights"]}
            exact = cuda or mode == "int8"  # the kernels' sums: the same at any height
            checks[name]["convs_held"] = (
                (conv_checks[name]["max_abs"] == 0.0 if exact
                 else conv_checks[name]["within_ulp"])
                and all(p["convs"] == (routed if mode == "bf16_packed" else n_convs)
                        for p in parts))
    r0 = ranks[0]
    services = serve_part_checks(ranks, refs, serve_refs, limits, routed, painted, cuda)
    rec = {"phase": "serve_runtime", "part": "edit_partition", "device": str(device),
           "size": size, "batch": batch, "dec_filters": list(model["dec_filters"]),
           "backend": "gloo", "routed_convs_per_decode": routed, "convs_per_decode": n_convs,
           "ranks_s": ranks_s, "launches": launches, "runs": runs, "limits": limits,
           "spread": spread, "halo_fault_gap": fault_gap, "halo_fault_margin": fault_margin,
           "conv_checks": conv_checks,
           "cli_gap": cli_gap,
           "cli_s": {"rank0_spatial": r0["cli_s"], **cli_s},
           "one_process": {mode: {"decode_s": refs[mode]["decode_s"],
                                  "peak_bytes": refs[mode]["peak_bytes"]}
                           for mode in EDIT_PART_MODES},
           "rank0_profile": {name: {k: v for k, v in r0["runs"][name]["profile"].items()
                                    if k != "top"}
                             for name in EDIT_PART_PROFILED if "profile" in r0["runs"][name]},
           "checks": checks,
           "tolerance": "each run's largest gap to the one-process card decode within "
                        "EDIT_PART_LIMIT_FACTOR x the largest of its mode's ulp-nudged "
                        "one-process decodes (EDIT_PART_SPREAD), at least EDIT_PART_LIMIT_MIN, "
                        "the largest and the mean gap each (int8: the mean); in bf16 and int8 "
                        "each kernel-run convolution bit for bit the unsharded one on the "
                        "gathered input (bf16 on the CPU: within one ulp); the zero-halo "
                        "fault's largest gap "
                        "at least EDIT_PART_FAULT_MARGIN x the f32 limit; "
                        "the 2-rank CLI within the f32 limit; the one-rank NCCL CLI bit for bit"}
    if cuda:
        rec["card"] = nvidia_smi()
    emit(rec)
    ok = (all(all(c.values()) for c in checks.values())
          and fault_margin["max_abs_err"] >= EDIT_PART_FAULT_MARGIN
          and cli_gap["spatial"]["files"] == batch
          and cli_gap["spatial"]["max_abs"] <= limits["f32"]["max_abs_err"]
          and cli_gap["one_rank"]["max_abs"] == 0.0)
    if not ok:
        raise RuntimeError(f"edit partition: checks {checks}, fault margin {fault_margin}, "
                           f"cli {cli_gap}, limits {limits}")
    if cuda:
        services["card"] = nvidia_smi()
    emit(services)
    if not all(all(c.values()) for c in services["checks"].values()):
        raise RuntimeError(f"partitioned services: {services['checks']}")
    return launches, services["launches"]


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


def routed_convs(module, x, shapes=None):
    """How many convolutions a forward of `module` on x sends to the packed
    kernel (`Conv.routes_to_kernel`), counted on the meta device in eval
    mode (which routes as training does, and takes no DropBlock draws).
    Each routed call's (B, Cin, Cout, H, W) is appended to the list
    `shapes` when one is given."""
    import torch

    from medical_image_editing_tpu_torch.models.blocks import Conv

    count = [0]

    def hook(m, args):
        routed = m.routes_to_kernel(args[0])
        count[0] += int(routed)
        if routed and shapes is not None:
            b, c, h, w = args[0].shape
            shapes.append((b, c, m.out_channels, h, w))

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


def f32_step_phase(device, cfg, *, size=256, batch=8, steps=2, seed=0):
    """The f32 readout of the packed conv's two f32 instances: the lung
    first stage at its config's widths (`configs/lung_first_stage.json`)
    with `compute_dtype` float32, 256², batch 8. One state, its codebook
    from k-means (cuDNN route, `ieee`), forked four times; on each of
    {ieee, tf32} × {packed, xla}, 1 + `steps` steps from the fork (the same
    weights, codebook and draws): step times (median of the warm ones), one
    profiled warm step on the card (device busy, each conv instance's
    device time, top kernels), launches (the total and each instance's
    under `conv_pack.LAUNCH_KEYS`; the counts zeroed
    just before the steps and read just after: on the card under `ieee` the
    packed route must launch only the CUDA-core instance, under `tf32` only
    the TF32 one, `xla` none; on the CPU nothing launches), and the first
    step's losses, packed − xla in each precision. Returns the launch
    counts by variant, the conv kernel's by instance among them."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops import conv_pack as tcp
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    model = cfg.model.vqmodel
    enc, dec = train_models(model, torch.float32, device, seed)
    base = train_state(cfg, enc, dec, device, seed)
    images = make_slices(np.random.default_rng(seed), batch, size)
    with conv_route("packed"):
        n_enc = routed_convs(enc, torch.zeros(1, int(model.in_channels), size, size))
        n_dec = routed_convs(dec, torch.zeros(1, enc.emb_dim, size, size))
    with conv_route("xla"), conv_precision("ieee"):
        init_codebook_step(enc)(base, images)
    sync()
    runs, launches = {}, {}
    for precision in ("ieee", "tf32"):
        inst = "tf32" if precision == "tf32" else "f32"
        for route in ("packed", "xla"):
            name = f"{precision}_{route}"
            state = fork_first_state(cfg, base, device)
            step = train_step_fn(cfg, state.encoder, state.decoder, torch.float32, device)
            n = (1 + steps) * 4 * (n_enc + n_dec) if cuda and route == "packed" else 0
            want = {tcp.KERNEL: n, **{key: n if i == inst else 0
                                      for i, key in tcp.LAUNCH_KEYS.items()}}
            with conv_precision(precision), conv_route(route):
                _build.launches.clear()
                # -- main path of the f32 instances: the steps
                step_s, losses = [], []
                for _ in range(1 + steps):
                    t0 = time.perf_counter()
                    state, metrics = step(state, images)
                    sync()
                    step_s.append(time.perf_counter() - t0)
                    losses.append({k: float(v) for k, v in metrics.items()})
                launches[name] = dict(_build.launches)
                counted = {k: launches[name].get(k, 0) for k in want}
                if cuda:
                    wall, kernels = profile_window(lambda: step(state, images))
            runs[name] = {
                "step_s": step_s, "warm_step_s_median": float(np.median(step_s[1:])),
                "launches": counted, "launches_expected": want, "losses_first": losses[0],
            }
            if cuda:
                tf32_off()
                runs[name]["instance_device_s"] = {
                    i: sum(device_us(e) for e in kernels if CONV_PATHS[i][0] in e.key) / 1e6
                    for i in ("f32", "tf32")}
                runs[name].update(kernel_breakdown(wall, kernels, 6))
            if counted != want or not all(np.isfinite(v) for m in losses for v in m.values()):
                raise RuntimeError(f"f32 step {name}: launches {counted}, derived {want}, "
                                   f"losses {losses}")
            del state, step
    gaps = {p: {k: runs[f"{p}_packed"]["losses_first"][k] - v
                for k, v in runs[f"{p}_xla"]["losses_first"].items()}
            for p in ("ieee", "tf32")}
    emit({"phase": "f32_step", "device": str(device), "size": size, "batch": batch,
          "steps": steps, "compute_dtype": "float32", "enc_filters": list(model.enc_filters),
          "dec_filters": list(model.dec_filters),
          "routed_convs": {"encoder": n_enc, "decoder": n_dec}, "runs": runs,
          "loss_gap_packed_minus_xla": gaps, "card": nvidia_smi() if cuda else None})
    return launches


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


def planted_run(run, name, argv, source, plant, final):
    """A planted faulty resume that writes no checkpoint: `run(name, argv,
    run={"resume_checkpoint": source})`, the CLI as `run_cli` runs it, with
    the state dict it restores from `source` changed in place by `plant`
    after loading, and its saves kept on the host, not written (every
    phase's resume check writes its own checkpoints; the planted runs'
    added ~2 × 2.2 GB a VQGAN run). Returns the state dict of the run's
    save named `final` (a `ckpt-epoch=...` name), on the CPU."""
    import torch

    from medical_image_editing_tpu_torch.train import trainer as trainer_module
    from medical_image_editing_tpu_torch.utils import checkpoint as ckpt

    restore, save, kept = trainer_module.restore_state, ckpt.CheckpointManager.save, {}

    def on_host_copy(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().clone()
        if isinstance(obj, dict):
            return {k: on_host_copy(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(on_host_copy(v) for v in obj)
        return copy.deepcopy(obj)

    def planted_restore(path, target, epoch=None):
        state = ckpt.load_state_file(ckpt.resolve(path, epoch), target.device)
        plant(state)
        target.load_state_dict(state)
        return target

    def kept_save(self, state, epoch, step=None):
        path = os.path.join(self.directory, ckpt._ckpt_name(epoch, step))
        if os.path.basename(path) == final:
            kept[final] = on_host_copy(state.state_dict())
        return path

    trainer_module.restore_state, ckpt.CheckpointManager.save = planted_restore, kept_save
    try:
        run(name, argv, run={"resume_checkpoint": str(source)})
    finally:
        trainer_module.restore_state, ckpt.CheckpointManager.save = restore, save
    if final not in kept:
        raise RuntimeError(f"planted run {name} saved no {final}")
    return kept[final]


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
    def drop_moments(state):
        state["enc_opt"]["state"], state["dec_opt"]["state"] = {}, {}

    planted_gap = state_gap(final_a, planted_run(
        run, "C", ["-m", "train"], run_b / "version_0" / "ckpt" / "ckpt-epoch=0001-step=00000007",
        drop_moments, "ckpt-epoch=0001"))
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


def trainer_checkpoint(workdir):
    """The checkpoint directory of `trainer_phase`'s run A in `workdir`."""
    study = json.loads(MODEL_CONFIG.read_text())["save"]["study_name"]
    return Path(workdir) / "A" / study / "version_0" / "ckpt"


# --------------------------------------------------------------------------
# the autoregressive prior (ROADMAP A item 20)
# --------------------------------------------------------------------------

# 64² images: the id grid has the image's resolution, so T = block_size =
# 4,096 tokens; at the lung config's 256² (65,536 tokens) one T × T f32
# attention tensor of one sample and one layer alone is 8 · 65,536² · 4 B
PRIOR_SIZE = 64
PRIOR_WIDTH = {"n_layer": 8, "n_head": 8, "n_embed": 256}  # the CLI's defaults
PRIOR_DROPOUT = 0.1  # the CLI's default
PRIOR_DECODE_POSITIONS = 256
# the cached decode against the full forward: 5× the largest gap of a
# spread of full forwards that differ at the rounding level (the sequence
# cut to the decoded positions, the batch reversed, float64), or a minimum
PRIOR_LIMIT_FACTOR = 5.0
PRIOR_LIMIT_MIN = 1e-6
PRIOR_REF_SIZE = 8  # (c): an 8² grid, 64 tokens, at full width


def prior_config(width, size, dict_size, dropout):
    from medical_image_editing_tpu_torch.models.mingpt import GPTConfig

    return GPTConfig(vocab_size=dict_size + 1, block_size=size * size, **width,
                     emb_pdrop=dropout, res_pdrop=dropout, att_pdrop=dropout)


def prior_phase(device, workdir, first_stage_ckpt, *, size=PRIOR_SIZE, batch=2, steps=3,
                width=None, seed=0, overrides=None, ref_size=PRIOR_REF_SIZE, defer=None):
    """The autoregressive prior at the CLI's width (`width` and `overrides`
    shrink it and the first stage for a CPU rehearsal): (a) the bare step,
    sampler and cached decode at `size`², (c) one step and a short cached
    decode held to the CPU path at `ref_size`² (its CPU side in a process of
    its own, joined as `second_stage_phase` says), (b) `train_prior.main` as
    a user runs it, freezing the first-stage checkpoint `first_stage_ckpt`.
    Returns the launches of (b), the main path."""
    model = json.loads(MODEL_CONFIG.read_text())["model"]["vqmodel"]
    dict_size = int((overrides or {}).get("model.vqmodel", {}).get("dict_size",
                                                                   model["dict_size"]))
    width = dict(width or PRIOR_WIDTH)
    prior_bare_part(device, size=size, batch=batch, steps=steps, width=width,
                    dict_size=dict_size, seed=seed)
    ref = start_reference("prior", {"width": width, "dict_size": dict_size}, size=ref_size,
                          batch=2, seed=seed + 1, card=device)
    launches = prior_cli_part(device, workdir, first_stage_ckpt, size=size, batch=batch,
                              steps=steps, width=width, overrides=overrides, seed=seed)
    finish_or_defer(ref, defer)
    return launches


def prior_bare_part(device, *, size, batch, steps, width, dict_size, seed):
    """(a) The prior's parts at `size`² (T = size² tokens) and `width`,
    dropout 0.1, on seeded id grids: `steps` train steps (the warm step's
    time, peak memory beside the derivation, one warm step under the
    profiler: busy and idle share), one sampler call of `batch` grids
    (seconds, tokens/s; its token step a CUDA graph, held bit for bit to the
    same step, `sample_token_step`, run eagerly on an 8 × 8 grid), and the
    cached decode's logits over the first PRIOR_DECODE_POSITIONS positions
    held to the full forward's within a limit from a spread."""
    import torch

    from medical_image_editing_tpu_torch.models.mingpt import forward_with_past
    from medical_image_editing_tpu_torch.train.prior import (
        create_prior_state,
        ids_to_sequence,
        make_prior_sampler,
        make_prior_train_step,
        sample_token_step,
    )

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tf32_off()
    cfg = prior_config(width, size, dict_size, PRIOR_DROPOUT)
    t = size * size
    state = create_prior_state(seed, cfg, device=device)
    step = make_prior_train_step(sos_token=dict_size)
    ids = torch.as_tensor(np.random.default_rng(seed).integers(0, dict_size, (batch, size, size)),
                          device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, ids)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated() if cuda else None
    warm = float(np.median(step_s[1:] or step_s))
    # what the backward keeps of each layer's T × T attention: the softmax
    # output (f32), the dropout's keep mask (bool) and the dropped weights
    # (f32); at most two more f32 T × T tensors live at once (the scores and
    # the uniform draws)
    tt = batch * cfg.n_head * t * t
    derived = {"kept_bytes": cfg.n_layer * tt * (4 + 1 + 4), "transient_bytes": 2 * tt * 4}
    derived["peak_bytes"] = derived["kept_bytes"] + derived["transient_bytes"]
    rec = {"phase": "prior", "part": "step", "device": str(device), "size": size,
           "tokens": t, "batch": batch, "steps": steps, "config": cfg._asdict(),
           "parameters": sum(p.numel() for p in state.gpt.parameters()),
           "step_s": step_s, "warm_step_s_median": warm, "losses": losses,
           "max_memory_allocated_bytes": peak, "derived_memory": derived}
    if cuda:
        wall, kernels, union = profile_union(lambda: step(state, ids))
        rec["profile"] = kernel_breakdown(wall, kernels, 8)
        rec["device_busy_union_s"] = union
        rec["device_idle_share_of_warm_step"] = 1.0 - union / warm

    # the sampler: one call of `batch` grids
    sample = make_prior_sampler(state.gpt, sos_token=dict_size, grid_hw=(size, size))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    sync()
    t0 = time.perf_counter()
    grids = sample(batch, generator=gen)
    sync()
    sample_s = time.perf_counter() - t0
    # the captured token step against the same step (`sample_token_step`)
    # run eagerly, on the same draws, over an 8 × 8 grid
    noise = -torch.log(-torch.log(torch.rand((64, batch, dict_size + 1), generator=gen,
                                             device=device).clamp_min_(1e-38)))
    replayed = make_prior_sampler(state.gpt, sos_token=dict_size, grid_hw=(8, 8))(
        batch, gumbel=noise)
    caches = state.gpt.init_cache(batch)
    tok = torch.full((batch, 1), dict_size, dtype=torch.long, device=device)
    pos = torch.zeros(1, dtype=torch.long, device=device)
    toks = torch.empty((64, batch), dtype=torch.long, device=device)
    for _ in range(64):
        sample_token_step(state.gpt, tok, caches, pos, toks, noise, sos_token=dict_size)
    eager = toks.t().reshape(batch, 8, 8).to(torch.int32)
    del caches
    rec.update({"sample_s": sample_s, "sample_tokens_per_s": batch * t / sample_s,
                "sample_ms_per_token_step": 1e3 * sample_s / t,
                "sample_shape": list(grids.shape),
                "sample_range": [int(grids.min()), int(grids.max())],
                "sample_graph_equals_eager": bool(torch.equal(replayed, eager))})

    # the cached decode against the full forward, and the spread of full
    # forwards that sets its limit
    n = min(PRIOR_DECODE_POSITIONS, t)
    gpt = state.gpt.eval()
    seq = ids_to_sequence(ids, dict_size)[:, :t]
    with torch.no_grad():
        full = gpt(seq)[:, :n].float()
        caches = gpt.init_cache(batch)
        decode = []
        for i in range(n):
            logits, caches = forward_with_past(gpt, seq[:, i:i + 1], caches, i)
            decode.append(logits[:, 0])
        decode = torch.stack(decode, 1)
        short = gpt(seq[:, :n])
        flipped = gpt(seq.flip(0))[:, :n].flip(0)
        full64 = copy.deepcopy(gpt).double()(seq[:, :n])
    del caches, gpt, state
    if cuda:
        torch.cuda.empty_cache()

    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    spread = {"sequence_cut": gap(short, full), "batch_reversed": gap(flipped, full),
              "float64": gap(full64, full)}
    limit = max(PRIOR_LIMIT_FACTOR * max(spread.values()), PRIOR_LIMIT_MIN)
    decode_gap = gap(decode, full)
    rec.update({"decode_positions": n, "decode_gap": decode_gap,
                "decode_gap_float64": gap(decode, full64), "decode_spread": spread,
                "decode_limit": limit, "logits_max_abs": float(full.abs().max()),
                "card": nvidia_smi() if cuda else None})
    emit(rec)
    checks = {
        "finite": all(np.isfinite(v) for m in losses for v in m.values()),
        "samples": tuple(grids.shape) == (batch, size, size) and grids.dtype == torch.int32
        and 0 <= int(grids.min()) and int(grids.max()) < dict_size,
        "graph_equals_eager": rec["sample_graph_equals_eager"],
        "decode": decode_gap <= limit,
    }
    if not all(checks.values()):
        raise RuntimeError(f"prior step: {checks}")


def prior_cli_part(device, workdir, first_stage_ckpt, *, size, batch, steps, width, overrides,
                   seed):
    """(b) `train_prior.main` in-process as a user runs it, on the lung
    config (`overrides` shrinks its first stage for a CPU rehearsal) at
    `image_size` [size, size] over a seeded lung tree of one patient's
    `batch × steps` slices, `--ckpt` the first-stage checkpoint, `--steps
    steps --batch batch --sample batch --log-every 1`, the CLI's default
    width (`width`'s flags when it is not PRIOR_WIDTH). Held: the files,
    their shapes and ranges, the step lines, the packed kernel's launches
    (its f32 `ieee` instance: every step extracts one batch's ids through
    the encoder, and the samples take one decoder forward) at the counts
    derived from the model, the VQ kernel's at 0 (the CLI's encoder takes
    the plain assignment, as JAX's `build_first_stage` does). Then, off the
    counted path, the kernel at each shape those launches take
    (`prior_conv_check`)."""
    import torch

    from medical_image_editing_tpu_torch.cli import train_prior
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops.conv_pack import LAUNCH_KEYS
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir) / "prior"
    write_lung_tree(work / "data", np.random.default_rng(seed + 3), patients=1,
                    slices=batch * steps, size=size)
    cfg = json.loads(MODEL_CONFIG.read_text())
    for section, values in (overrides or {}).items():
        node = cfg
        for key in section.split("."):
            node = node[key]
        node.update(values)
    cfg["dataset"].update(root_dir_path=str(work / "data"), image_size=[size, size])
    cfg_path = work / "prior.json"
    cfg_path.write_text(json.dumps(cfg))
    model = cfg["model"]["vqmodel"]
    dict_size = int(model["dict_size"])

    enc, dec, grid = train_prior.build_first_stage(cfg, device="cpu")
    shapes = []  # the extraction's and the decode's, both at `batch`
    n_enc = routed_convs(enc, torch.zeros(batch, int(model.get("in_channels", 1)), size, size),
                         shapes)
    n_dec = routed_convs(dec, torch.zeros(batch, enc.emb_dim, *grid), shapes)
    del enc, dec
    n = steps * n_enc + n_dec
    want = {"conv3x3_packed": n, LAUNCH_KEYS["f32"]: n, "vq_fused": 0,
            **{k: 0 for k in S8_KERNELS}} if cuda else {}

    out = work / "out"
    argv = ["-c", str(cfg_path), "--ckpt", str(first_stage_ckpt), "--steps", str(steps),
            "--batch", str(batch), "--sample", str(batch), "--log-every", "1",
            "--seed", str(seed), "--out", str(out)]
    if width != PRIOR_WIDTH:
        argv += ["--n-layer", str(width["n_layer"]), "--n-head", str(width["n_head"]),
                 "--n-embd", str(width["n_embed"])]
    if not cuda:
        argv += ["--device", "cpu"]
    log = io.StringIO()
    _build.launches.clear()
    # -- main path: the CLI
    t0 = time.perf_counter()
    with conv_precision("ieee"), contextlib.redirect_stdout(log):
        rc = train_prior.main(argv)
        if cuda:
            torch.cuda.synchronize()
        tf32_off()
    path_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    print(log.getvalue(), end="", flush=True)

    lines = re.findall(r"step (\d+): loss=([-\w.]+) acc=([-\w.]+)", log.getvalue())
    ids = np.load(out / "sample_ids.npy")
    stored = load_state_file(str(out / "prior_ckpt"))
    rec = {"phase": "prior", "part": "cli", "device": str(device), "size": size,
           "batch": batch, "steps": steps, "config": stored["config"],
           "first_stage": {"enc_filters": model["enc_filters"],
                           "dec_filters": model["dec_filters"], "dict_size": dict_size},
           "routed_convs": {"encoder": n_enc, "decoder": n_dec},
           "launches": launches, "launches_expected": want, "path_s": path_s,
           "step_lines": [[int(s), float(loss), float(acc)] for s, loss, acc in lines],
           "sample_ids_shape": list(ids.shape), "sample_ids_dtype": str(ids.dtype),
           "sample_ids_range": [int(ids.min()), int(ids.max())],
           "samples_png_bytes": os.path.getsize(out / "samples.png"),
           "card": nvidia_smi() if cuda else None}
    emit(rec)
    # off the counted path: the kernel at each of the path's shapes
    prior_conv_check(device, sorted(set(shapes)), seed)
    checks = {
        "rc": rc == 0,
        "restored": f"first stage restored from {first_stage_ckpt}" in log.getvalue(),
        "step_lines": [int(s) for s, _, _ in lines] == list(range(1, steps + 1))
        and all(np.isfinite(float(v)) for _, v, _ in lines),
        "prior_ckpt": stored["config"]["block_size"] == size * size
        and all(stored["config"][k] == v for k, v in width.items()),
        "samples_png": (out / "samples.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n",
        "sample_ids": ids.shape == (batch, size, size) and ids.dtype == np.int32
        and 0 <= ids.min() and ids.max() < dict_size,
        "launches": ({k: launches.get(k, 0) for k in want} == want) if cuda else launches == {},
    }
    if not all(checks.values()):
        raise RuntimeError(f"prior CLI: {checks}")
    return launches


def prior_conv_check(device, shapes, seed):
    """The packed conv kernel's f32 (ieee) instance, forward, at each (B,
    Cin, Cout, H, W) of `shapes` (the prior CLI's extraction and decode)
    against its plain version on seeded inputs scaled as the conv phase's,
    within the conv phase's f32 tolerance (|err| <= 1e-4: sums in another
    order). On the card each call must launch the f32 instance once, and
    `shapes` must not be empty."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops import conv_pack as tcp

    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    errs, launched = {}, {}
    with conv_precision("ieee"):
        tf32_off()
        for b, cin, cout, h, w in shapes:
            x = torch.randn(b, cin, h, w, generator=gen, device=device)
            wt = ((torch.rand(cout, cin, 3, 3, generator=gen, device=device) * 2 - 1)
                  / (9 * cin) ** 0.5)
            before = _build.launches.copy()
            got = tcp.conv3x3_packed_nchw(x, wt)
            ref = tcp.conv3x3_packed_reference_nchw(x, wt)
            key = f"{b}x{cin}x{cout}x{h}x{w}"
            errs[key] = float((got - ref).abs().max())
            launched[key] = dict(_build.launches - before)
    want = {tcp.KERNEL: 1, tcp.LAUNCH_KEYS["f32"]: 1} if cuda else {}
    emit({"phase": "prior", "part": "conv", "device": str(device), "instance": "f32",
          "shapes": len(shapes), "max_abs_err": errs, "tolerance": "|err| <= 1e-4"})
    bad = {k: (e, launched[k]) for k, e in errs.items()
           if not e <= 1e-4 or launched[k] != want}
    if bad or (cuda and not shapes):
        raise RuntimeError(f"conv3x3_packed (f32) at the prior's shapes: {bad or 'no shapes'}")


def prior_reference_context(spec, size, batch, seed, setup=None):
    """The card-vs-CPU part of the prior phase: one train step (dropout 0)
    and a cached decode of the first 16 positions after it, at the width
    of `spec` on a `size`² id grid, from the same weights (`pos_embed`
    drawn non-zero) and ids on both (`setup`, made here when None). Held
    (`prior_reference_check`): the loss rtol 1e-5, the accuracy within one
    token, the decode's logits atol 1e-4, and the gradients against a
    witness that does not depend on the card (fault C.6's rule): the same
    step in float64 on the CPU; the card's distance from it (relative
    Frobenius norm over every parameter) within 5× the larger of the two
    CPU float32 steps' (oneDNN on and off), or 1e-5, at most 1e-3. A card
    of "cpu" rehearses the comparison."""
    import torch

    from medical_image_editing_tpu_torch.models.mingpt import GPT, forward_with_past
    from medical_image_editing_tpu_torch.train.prior import (
        PriorTrainState,
        ids_to_sequence,
        make_prior_optimizer,
        make_prior_train_step,
        prior_loss,
    )
    from medical_image_editing_tpu_torch.utils.witness import float64_step

    dict_size = int(spec["dict_size"])
    cfg = prior_config(spec["width"], size, dict_size, 0.0)
    ids = np.random.default_rng(seed).integers(0, dict_size, (batch, size, size))
    if setup is None:
        gen = torch.Generator().manual_seed(seed)
        gpt = GPT(cfg).init_weights(gen)
        with torch.no_grad():
            gpt.pos_embed.copy_(0.3 * torch.randn(gpt.pos_embed.shape, generator=gen))
        setup = {"start": gpt.state_dict()}
    parts = (("gpt", None),)
    positions = min(16, size * size)

    def fresh(device):
        gpt = GPT(cfg)
        gpt.load_state_dict(setup["start"])
        return gpt.to(device)

    def grads(gpt):
        return {"gpt": torch.cat([p.grad.detach().flatten().cpu() for p in gpt.parameters()])}

    def witness(_vq_ids):
        gpt = fresh("cpu").double()
        with float64_step([]):
            loss, _ = prior_loss(gpt, torch.as_tensor(ids), dict_size)
        loss.backward()
        return grads(gpt)

    def run(name, device, use_mkldnn):
        gpt = fresh(device)
        state = PriorTrainState(gpt, make_prior_optimizer(gpt.parameters(), 3e-4),
                                torch.Generator(device=device))
        x = torch.as_tensor(ids, device=device)
        with torch.backends.mkldnn.flags(enabled=use_mkldnn):
            state, m = make_prior_train_step(sos_token=dict_size)(state, x)
            g = grads(gpt)
            gpt.eval()
            seq = ids_to_sequence(x, dict_size)
            caches = gpt.init_cache(batch)
            logits = []
            with torch.no_grad():
                for i in range(positions):
                    out, caches = forward_with_past(gpt, seq[:, i:i + 1], caches, i)
                    logits.append(out[:, 0].cpu())
        return SimpleNamespace(vq_ids=[], m={k: float(v) for k, v in m.items()}, grads=g,
                               decode=torch.stack(logits, 1))

    return SimpleNamespace(setup=setup, start=setup["start"], parts=parts, witness=witness,
                           run=run, cpu_runs=[("cpu", (True,)), ("cpu_native", (False,))],
                           card_runs=lambda card: [("card", (True,))])


def prior_reference_check(handle, witnesses):
    """The prior part's checks and record (see `prior_reference_context`)."""
    from medical_image_editing_tpu_torch.utils.witness import witness_gaps, witness_limits

    out, parts = handle.out, handle.ctx.parts
    cpu, c = out["cpu"], out["card"]
    gaps, n_witness = witness_gaps(out, handle.ctx.witness, parts, witnesses)
    floor, grad_limit = witness_limits(gaps, WITNESS_MINIMUM["prior"], WITNESS_CAP["prior"])
    loss_err = abs(c.m["loss"] - cpu.m["loss"]) / abs(cpu.m["loss"])
    acc_err = abs(c.m["acc"] - cpu.m["acc"])
    one_token = 1.0 / (handle.batch * handle.size * handle.size)
    decode_err = float((c.decode - cpu.decode).abs().max())
    rec = {"phase": "prior", "part": "reference", "card": handle.card, "size": handle.size,
           "batch": handle.batch, "loss_rel_err": loss_err, "acc_err": acc_err,
           "decode_max_abs_err": decode_err, "grad_rel_err_vs_f64": gaps,
           "grad_floor": floor, "grad_limit": grad_limit, "witnesses": n_witness,
           "readout_grad_rel_err_vs_cpu": float((c.grads["gpt"] - cpu.grads["gpt"]).norm()
                                                / cpu.grads["gpt"].norm()),
           "losses_cpu": cpu.m, "losses_card": c.m, **handle.timing,
           "tolerance": "loss rtol 1e-5; accuracy within one token; the decode's logits "
                        "atol 1e-4; gradients: the card's distance from a float64 CPU step "
                        "within 5x the larger of the CPU's two float32 steps' (oneDNN on, "
                        "off) or 1e-5, at most WITNESS_CAP (relative Frobenius)"}
    emit(rec)
    if loss_err > 1e-5 or acc_err > one_token + 1e-12 or decode_err > 1e-4 or any(
            gaps["card"][m] > grad_limit[m] for m in grad_limit):
        raise RuntimeError(f"card vs CPU prior step: loss {loss_err}, acc {acc_err}, decode "
                           f"{decode_err}, gradients against float64 {gaps} "
                           f"(limits {grad_limit})")


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


def second_stage_phase(device, workdir, *, size=256, batch=8, steps=3, seed=0, overrides=None,
                       ref_size=64, defer=None):
    """The second (adversarial) stage at the lung second-stage config's
    widths (`overrides` shrinks it for a CPU rehearsal): (a) the bare step,
    one step held to the CPU path on a small input (its CPU side in a
    process of its own, joined after (b), or by the caller when `defer` is
    a list: the part's handle is appended to it), (b) the run through
    `run_vqwnet.main` staged from the trainer phase's run-A first stage in
    `workdir`. Returns the launches of (a) and (b)."""
    launches = second_stage_step_part(device, overrides, size=size, batch=batch, steps=steps,
                                      seed=seed)
    ref = start_reference("second_stage", overrides, size=ref_size, batch=2, seed=seed + 1,
                          card=device)
    run = second_stage_run_part(device, workdir, overrides, seed=seed)
    finish_or_defer(ref, defer)
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


# The card-vs-CPU parts of the second_stage, multi_window and vqgan phases
# run their CPU side (the two float32 CPU steps and the float64 witnesses of
# their ids) in a spawned process of REFERENCE_THREADS torch threads, while
# the card goes on with the next parts; `finish_reference` joins it before
# the checks. A CPU rehearsal gives the process the caller's thread count,
# so that its steps equal the caller's bit for bit.
REFERENCE_THREADS = 4
REFERENCE_TIMEOUT_S = 1200


def reference_cpu_side(kind, args, setup_file, out_file, threads):
    """The CPU side of a card-vs-CPU part, in a process of its own: the
    part's CPU runs from the caller's setup (the same start, draws and
    images), and the float64 witness of each distinct sequence of their
    ids; saved to `out_file`."""
    import torch

    from medical_image_editing_tpu_torch.utils.witness import ids_key

    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ctx = REFERENCE_KINDS[kind](*args, setup=torch.load(setup_file, weights_only=False))
    out = {name: ctx.run(name, "cpu", *flags) for name, flags in ctx.cpu_runs}
    witnesses = {}
    for o in out.values():
        key = ids_key(o.vq_ids)
        if key not in witnesses:
            witnesses[key] = ctx.witness(o.vq_ids)
    torch.save({"out": out, "witnesses": witnesses, "seconds": time.perf_counter() - t0,
                "threads": threads}, out_file)


def start_reference(kind, overrides, *, size, batch, seed, card):
    """Set up a card-vs-CPU part on the CPU (seeded weights, k-means,
    draws), start its CPU side in a spawned process, and run its card side
    here. Returns the handle `finish_reference` takes."""
    import torch

    tf32_off()  # held to the CPU at full f32
    t0 = time.perf_counter()
    args = (overrides, size, batch, seed)
    ctx = REFERENCE_KINDS[kind](*args)
    tmp = Path(tempfile.mkdtemp(prefix=f"reference-{kind}-"))
    torch.save(ctx.setup, tmp / "setup.pt")
    threads = (torch.get_num_threads() if torch.device(card).type == "cpu"
               else REFERENCE_THREADS)
    proc = torch.multiprocessing.get_context("spawn").Process(
        target=reference_cpu_side,
        args=(kind, args, str(tmp / "setup.pt"), str(tmp / "cpu_side.pt"), threads))
    proc.start()
    try:
        out = {name: ctx.run(name, card, *flags) for name, flags in ctx.card_runs(card)}
    except BaseException:
        proc.kill()
        proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return SimpleNamespace(kind=kind, ctx=ctx, proc=proc, tmp=tmp, out=out, card=card,
                           size=size, batch=batch, seconds=time.perf_counter() - t0)


def finish_reference(handle):
    """Join the CPU side of a part started by `start_reference`, then hold
    the card to it (the part's checks)."""
    import torch

    t0 = time.perf_counter()
    handle.proc.join(REFERENCE_TIMEOUT_S)
    try:
        if handle.proc.is_alive():
            handle.proc.kill()
            handle.proc.join()
            raise RuntimeError(f"{handle.kind} reference: the CPU side ran past "
                               f"{REFERENCE_TIMEOUT_S} s")
        if handle.proc.exitcode != 0:
            raise RuntimeError(f"{handle.kind} reference: the CPU side exited with "
                               f"{handle.proc.exitcode}")
        side = torch.load(handle.tmp / "cpu_side.pt", weights_only=False)
    finally:
        shutil.rmtree(handle.tmp, ignore_errors=True)
    handle.out = {**side["out"], **handle.out}
    handle.timing = {"card_side_s": handle.seconds, "cpu_side_s": side["seconds"],
                     "cpu_side_threads": side["threads"],
                     "join_wait_s": time.perf_counter() - t0}
    REFERENCE_CHECKS[handle.kind](handle, side["witnesses"])


# The card's gradients against the float64 witness (fault C.6): within 5×
# the larger of the CPU float32 steps' distances from it, or a minimum, and
# never above the limits that the card's own perturbed floors gave these
# checks on an NVIDIA H100 80GB HBM3 at 700 W before the witness replaced
# them (WITNESS_CAP: fixed numbers, so that no fault of the card in this run
# moves them). The multi-window minimum is 5× the others': the card's packed
# f32 convolution adds each tap's 9·Cin products in sequence, and the
# mediastinal window multiplies the reconstruction's rounding by 10.24 before
# the discriminator sees it (on an H100 the card's discriminator gradient
# sat 1.6e-4 from float64, the CPU's 1.4e-5; through cuDNN 4.4e-5).
WITNESS_MINIMUM = {"second_stage": 1e-4, "multi_window": 5e-4, "vqgan": 1e-4, "prior": 1e-5}
WITNESS_CAP = {
    "second_stage": {"decoder": 8.67e-3, "discriminator": 2.43e-4},
    "multi_window": {"encoder": 1.409, "decoder": 3.42e-2, "discriminator": 7.83e-4},
    "vqgan": {"decoder": 1.66e-4, "discriminator": 6.26e-4},
    "prior": {"gpt": 1e-3},  # no card floor before it: a fixed bound of its own
}


def second_stage_reference_context(overrides, size, batch, seed, setup=None):
    """The card-vs-CPU part of the second_stage phase: one second-stage step
    on the card vs the same step on the port's CPU path, at the config's
    widths in f32 (TF32 off) on a small input, packed route: the same
    weights, codebook (k-means on the CPU) and CutMix draws on both
    (`setup`, made here when None). Held (`second_stage_reference_check`):
    the ids where the top-2 score gap is clear of rounding, every loss
    (rtol 1e-3), and the gradients of decoder and discriminator read from
    Adam's first moment against a witness that does not depend on the card
    (fault C.6): the same step in float64 on the CPU from each run's own
    ids (`float64_step`). The card's distance from it (relative Frobenius
    norm) is held within 5× the larger of the two CPU float32 steps'
    (oneDNN's convolutions, PyTorch's native ones), or 1e-4, and at most
    WITNESS_CAP. The card's other conv route and the card without cuDNN
    are readouts, and so is the card's distance from the CPU's float32
    step. A card of "cpu" rehearses the comparison."""
    import torch

    from medical_image_editing_tpu_torch.models.unet_encoder import encode_quantize
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws
    from medical_image_editing_tpu_torch.utils.witness import (
        first_moments,
        float64_step,
        recorded_vq_ids,
        to_float64,
    )

    cfg = second_config(overrides, **{"model.vqmodel": {"compute_dtype": "float32"}})
    images = make_slices(np.random.default_rng(seed), batch, size)
    if setup is None:
        trainer, state = second_state(cfg, "cpu", seed)
        init_codebook_step(state.encoder)(state, images)
        setup = {"start": {m: copy.deepcopy(getattr(state, m).state_dict())
                           for m in ("encoder", "decoder", "discriminator")},
                 "draws": sample_cutmix_draws(torch.Generator().manual_seed(seed),
                                              trainer.second_cfg.n_inner_loops, size, size)}
    start, draws = setup["start"], setup["draws"]
    parts = (("decoder", "dec_opt"), ("discriminator", "dis_opt"))

    def fresh(device):
        trainer, state = second_state(cfg, device, seed)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        return trainer, state, on

    def witness(ids_calls):
        trainer, state, on = fresh("cpu")
        to_float64(state.encoder, state.decoder, state.discriminator)
        with float64_step(ids_calls), conv_route("xla"):
            second_step_fn(trainer, state, "cpu")(state, images, draws=on)
        return first_moments(state, parts)

    def run(name, device, route, use_cudnn, use_mkldnn):
        trainer, state, on = fresh(device)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device)
            feats = state.encoder.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            _, _, ids, _ = encode_quantize(state.encoder, state.vq, x, train=False,
                                           backend=state.encoder.knn_backend)
        prev_cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = use_cudnn
        try:
            with conv_route(route), recorded_vq_ids() as seen, \
                    torch.backends.mkldnn.flags(enabled=use_mkldnn):
                _, metrics = second_step_fn(trainer, state, device)(state, images, draws=on)
        finally:
            torch.backends.cudnn.enabled = prev_cudnn
        return SimpleNamespace(feats=feats.cpu(), ids=ids.cpu(), vq_ids=seen,
                               m={k: float(v) for k, v in metrics.items()},
                               grads=first_moments(state, parts))

    def card_runs(card):
        runs = [("card", ("packed", True, True))]
        if torch.device(card).type == "cuda":  # without the conv kernel, and without cuDNN
            runs += [("card_xla", ("xla", True, True)), ("card_no_cudnn", ("xla", False, True))]
        return runs

    return SimpleNamespace(setup=setup, start=start, parts=parts, witness=witness, run=run,
                           cpu_runs=[("cpu", ("packed", True, True)),
                                     ("cpu_native", ("packed", True, False))],
                           card_runs=card_runs)


def second_stage_reference_check(handle, witnesses):
    """The second_stage part's checks and record (see
    `second_stage_reference_context`)."""
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.utils.witness import (
        witness_gaps,
        witness_limits,
    )

    ctx, out, parts = handle.ctx, handle.out, handle.ctx.parts
    cpu, c = out["cpu"], out["card"]
    top2 = vq_scores(ctx.start["encoder"]["vq.embed"],
                     cpu.feats.reshape(-1, cpu.feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(cpu.ids.shape)
    id_mismatch = int(((c.ids != cpu.ids) & clear).sum())
    loss_err = {k: abs(c.m[k] - v) / max(abs(v), 1e-6) for k, v in cpu.m.items()}
    gaps, n_witness = witness_gaps(out, ctx.witness, parts, witnesses)
    floor, grad_limit = witness_limits(gaps, WITNESS_MINIMUM["second_stage"],
                                       WITNESS_CAP["second_stage"])
    grad_err = gaps["card"]
    readouts = {name: {m: float((o.grads[m] - cpu.grads[m]).norm() / cpu.grads[m].norm())
                       for m, _ in parts}
                for name, o in out.items() if name.startswith("card")}
    route_floor = {m: 0.0 for m, _ in parts}
    if "card_xla" in out:
        route_floor = {m: float((out["card_xla"].grads[m] - g).norm() / g.norm())
                       for m, g in c.grads.items()}

    rec = {"phase": "second_stage", "part": "reference", "card": handle.card,
           "size": handle.size, "batch": handle.batch,
           "id_mismatches_clear": id_mismatch, "clear_share": float(clear.float().mean()),
           "loss_rel_err": loss_err, "grad_rel_err_vs_f64": gaps, "grad_floor": floor,
           "grad_limit": grad_limit, "witnesses": n_witness,
           "readout_grad_rel_err_vs_cpu": readouts, "readout_card_route_floor": route_floor,
           "losses_cpu": cpu.m, "losses_card": c.m, **handle.timing,
           "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; losses rtol "
                        "1e-3; gradients (Adam's first moment): the card's distance from a "
                        "float64 CPU step on its own ids within 5x the larger of the CPU's "
                        "two float32 steps' (oneDNN, native) or 1e-4, at most WITNESS_CAP "
                        "(relative Frobenius; the card's other routes and its distance from "
                        "the CPU readouts)"}
    emit(rec)
    if id_mismatch or max(loss_err.values()) > 1e-3 or any(
            grad_err[m] > grad_limit[m] for m in grad_err):
        raise RuntimeError(f"card vs CPU second-stage step: {id_mismatch} clear id "
                           f"mismatches, loss errors {loss_err}, gradient errors against "
                           f"float64 {gaps} (limits {grad_limit})")


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
    def drop_dis_state(state):
        state["dis_opt"]["state"] = {}
        gen = torch.Generator().manual_seed(seed)
        for k, v in state["discriminator"].items():
            if k.endswith("u0"):
                state["discriminator"][k] = torch.randn(v.shape, generator=gen)
            elif k.endswith("sv0"):
                state["discriminator"][k] = torch.ones_like(v)

    planted_gap = state_gap(final_a, planted_run(
        run, "2C", ["-m", "train", "--max-steps", str(total)],
        run_b / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003", drop_dis_state, last))
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


def multi_window_phase(device, workdir, *, size=256, batch=8, steps=2, mode_steps=2, seed=0,
                       overrides=None, ref_size=64, defer=None):
    """The multi-window trainer at the widths of
    `configs/lung_multiwindow_joint.json` (`overrides` shrinks it for a CPU
    rehearsal): (a) the bare joint step, and the multi-window first and
    second steps; (c) one joint step held to the CPU path on a small input
    (its CPU side in a process of its own, joined as `second_stage_phase`
    says); (b) the run through `run_vqwnet.main -w` over the trainer
    phase's tree in `workdir`. Returns the launches of (a) and (b)."""
    launches = multi_window_step_part(device, overrides, size=size, batch=batch, steps=steps,
                                      mode_steps=mode_steps, seed=seed)
    ref = start_reference("multi_window", overrides, size=ref_size, batch=2, seed=seed + 1,
                          card=device)
    run = multi_window_run_part(device, workdir, overrides, seed=seed)
    finish_or_defer(ref, defer)
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


def multi_window_reference_context(overrides, size, batch, seed, setup=None):
    """The card-vs-CPU part of the multi_window phase: one joint step on the
    card vs the same step on the port's CPU path, at the joint config's
    widths in f32 (TF32 off) on a small input, packed route: the same
    weights, codebook (k-means on the CPU) and draws on both (`setup`, made
    here when None). Held (`multi_window_reference_check`): the ids where
    the top-2 score gap is clear of rounding, every loss (rtol 1e-3; 1e-2
    for cross, dist, recon, freq and the totals), and the gradients of
    encoder, decoder and discriminator read from Adam's first moment
    against the float64 witness of each run's own ids (fault C.6;
    `float64_step`: the augmented views and the cross-view id warps in
    float32, as the CPU step computes them): the card within 5× the larger
    of the two CPU float32 steps' distances (oneDNN's convolutions,
    PyTorch's native ones), or 5e-4, at most WITNESS_CAP. The card's other
    conv route and its distance from the CPU's float32 step are readouts.
    The 1e-2 terms are those an id flipped at a near tie inside the step
    moves. A card of "cpu" rehearses the comparison."""
    import torch

    from medical_image_editing_tpu_torch.models.unet_encoder import encode_quantize
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.utils.witness import (
        first_moments,
        float64_step,
        recorded_vq_ids,
        to_float64,
    )

    cfg = mw_config(overrides, **{"model.vqmodel": {"compute_dtype": "float32"}})
    images = make_slices(np.random.default_rng(seed), batch, size)
    if setup is None:
        trainer, state = second_state(cfg, "cpu", seed, multi_window=True)
        init_codebook_step(state.encoder)(state, images)
        setup = {"start": {m: copy.deepcopy(getattr(state, m).state_dict())
                           for m in ("encoder", "decoder", "discriminator")},
                 "draws": joint_draws(trainer, torch.Generator().manual_seed(seed), batch,
                                      size)}
    start, draws = setup["start"], setup["draws"]
    parts = (("encoder", "enc_opt"), ("decoder", "dec_opt"), ("discriminator", "dis_opt"))

    def fresh(device):
        trainer, state = second_state(cfg, device, seed, multi_window=True)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        return trainer, state

    def witness(ids_calls):
        trainer, state = fresh("cpu")
        to_float64(state.encoder, state.decoder, state.discriminator)
        trainer.compute_dtype = torch.float64  # the first stage's inputs to the encoder
        with float64_step(ids_calls), conv_route("xla"):
            trainer.train_step(state, images, draws_to(draws, "cpu"))
        return first_moments(state, parts)

    def run(name, device, route, use_mkldnn):
        trainer, state = fresh(device)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device)
            feats = state.encoder.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            _, _, ids, _ = encode_quantize(state.encoder, state.vq, x, train=False,
                                           backend=state.encoder.knn_backend)
        with conv_route(route), recorded_vq_ids() as seen, \
                torch.backends.mkldnn.flags(enabled=use_mkldnn):
            _, metrics = trainer.train_step(state, images, draws_to(draws, device))
        return SimpleNamespace(feats=feats.cpu(), ids=ids.cpu(), vq_ids=seen,
                               m={k: float(v) for k, v in metrics.items()},
                               grads=first_moments(state, parts))

    def card_runs(card):
        runs = [("card", ("packed", True))]
        if torch.device(card).type == "cuda":
            runs.append(("card_xla", ("xla", True)))
        return runs

    return SimpleNamespace(setup=setup, start=start, parts=parts, witness=witness, run=run,
                           cpu_runs=[("cpu", ("packed", True)), ("cpu_native", ("packed", False))],
                           card_runs=card_runs)


def multi_window_reference_check(handle, witnesses):
    """The multi_window part's checks and record (see
    `multi_window_reference_context`)."""
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.utils.witness import (
        witness_gaps,
        witness_limits,
    )

    ctx, out, parts = handle.ctx, handle.out, handle.ctx.parts
    cpu, c = out["cpu"], out["card"]
    top2 = vq_scores(ctx.start["encoder"]["vq.embed"],
                     cpu.feats.reshape(-1, cpu.feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(cpu.ids.shape)
    id_mismatch = int(((c.ids != cpu.ids) & clear).sum())
    loss_err = {k: abs(c.m[k] - v) / max(abs(v), 1e-6) for k, v in cpu.m.items()}
    rtol = {k: 1e-2 if k in ("cross", "dist", "recon", "freq", "total", "gen_total") else 1e-3
            for k in loss_err}
    gaps, n_witness = witness_gaps(out, ctx.witness, parts, witnesses)
    floor, grad_limit = witness_limits(gaps, WITNESS_MINIMUM["multi_window"],
                                       WITNESS_CAP["multi_window"])
    grad_err = gaps["card"]
    readouts = {name: {m: float((o.grads[m] - cpu.grads[m]).norm() / cpu.grads[m].norm())
                       for m, _ in parts}
                for name, o in out.items() if name.startswith("card")}
    route_floor = {m: 0.0 for m, _ in parts}
    if "card_xla" in out:
        route_floor = {m: float((out["card_xla"].grads[m] - g).norm() / g.norm())
                       for m, g in c.grads.items()}
    rec = {"phase": "multi_window", "part": "reference", "card": handle.card,
           "size": handle.size, "batch": handle.batch, "id_mismatches_clear": id_mismatch,
           "clear_share": float(clear.float().mean()), "loss_rel_err": loss_err,
           "grad_rel_err_vs_f64": gaps, "grad_floor": floor, "grad_limit": grad_limit,
           "witnesses": n_witness, "readout_grad_rel_err_vs_cpu": readouts,
           "readout_card_route_floor": route_floor,
           "losses_cpu": cpu.m, "losses_card": c.m, **handle.timing,
           "tolerance": f"ids equal where the top-2 score gap > 1e-4·max|score|; losses rtol "
                        f"{rtol}; gradients (Adam's first moment): the card's distance from "
                        "a float64 CPU step on its own ids within 5x the larger of the CPU's "
                        "two float32 steps' (oneDNN, native) or 5e-4, at most WITNESS_CAP "
                        "(relative Frobenius; the card's other route and its distance from "
                        "the CPU readouts)"}
    emit(rec)
    if id_mismatch or any(loss_err[k] > rtol[k] for k in loss_err) or any(
            grad_err[m] > grad_limit[m] for m in grad_err):
        raise RuntimeError(f"card vs CPU joint step: {id_mismatch} clear id mismatches, loss "
                           f"errors {loss_err}, gradient errors against float64 {gaps} "
                           f"(limits {grad_limit})")


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
    def drop_dis_state(state):
        state["dis_opt"]["state"] = {}
        gen = torch.Generator().manual_seed(seed)
        for k, v in state["discriminator"].items():
            if k.endswith("u0"):
                state["discriminator"][k] = torch.randn(v.shape, generator=gen)
            elif k.endswith("sv0"):
                state["discriminator"][k] = torch.ones_like(v)

    planted_gap = state_gap(final_a, planted_run(
        run, "wC", ["-m", "train", "--max-steps", str(total)],
        run_b / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003", drop_dis_state, last))
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


def vqgan_phase(device, workdir, *, size=512, batch=8, steps=2, seed=0, overrides=None,
                ref_size=128, patients=2, slices=20, defer=None, run_size=None):
    """The VQGAN trainer at the widths of `configs/crc_vqgan.json`
    (`overrides` shrinks it for a CPU rehearsal): (a) the bare step and a
    painted decode at `size`², (c) one step held to the CPU path on a small
    input (its CPU side in a process of its own, joined as
    `second_stage_phase` says), (b) the run through `run_vqwnet.main -v`
    over a seeded CRC tree in `workdir` at `run_size`² (None: the smaller of
    `size` and VQGAN_RUN_SIZE). Returns the launches of (a) and (b)."""
    launches = vqgan_step_part(device, overrides, size=size, batch=batch, steps=steps,
                               seed=seed)
    ref = start_reference("vqgan", overrides, size=ref_size, batch=2, seed=seed + 1,
                          card=device)
    run = vqgan_run_part(device, workdir, overrides, size=run_size or min(size, VQGAN_RUN_SIZE),
                         patients=patients, slices=slices, seed=seed)
    finish_or_defer(ref, defer)
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


def vqgan_reference_context(overrides, size, batch, seed, setup=None):
    """The card-vs-CPU part of the vqgan phase: one VQGAN step on the card vs
    the same step on the port's CPU path, at the config's widths in f32
    (TF32 off) on a small input (128², the 512 discriminator's smallest):
    the same weights and CutMix draws on both (`setup`, made here when
    None). Held (`vqgan_reference_check`): the ids
    where the top-2 score gap is clear of rounding, every loss and the
    codebook (rtol 1e-3), and the gradients of the VQGAN and the
    discriminator read from Adam's first moment against the float64
    witness of each run's own ids (fault C.6): the card within 5× the
    larger of the two CPU float32 steps' distances (oneDNN's convolutions,
    PyTorch's native ones), or 1e-4, and at most WITNESS_CAP. Two
    perturbations of the card's step at the rounding level are readouts:
    cuDNN off, and the quantized features moved by one ulp up or down at
    random (`ulp_nudged_quantization`: at random init every id is one
    code, the decoder's input is constant over space, and its GroupNorm
    divides rounding noise by √eps); so is the card's distance from the
    CPU's float32 step. A card of "cpu" rehearses the comparison."""
    import torch

    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws
    from medical_image_editing_tpu_torch.utils.witness import (
        first_moments,
        float64_step,
        recorded_vq_ids,
        to_float64,
    )

    cfg = vqgan_config(overrides)
    images = make_slices(np.random.default_rng(seed), batch, size)
    if setup is None:
        trainer, state = vqgan_state(cfg, "cpu", seed)
        setup = {"start": {m: copy.deepcopy(getattr(state, m).state_dict())
                           for m in ("decoder", "discriminator")},
                 "draws": sample_cutmix_draws(torch.Generator().manual_seed(seed),
                                              trainer.second_cfg.n_inner_loops, size, size)}
        del state
    start, draws = setup["start"], setup["draws"]
    parts = (("decoder", "dec_opt"), ("discriminator", "dis_opt"))

    def fresh(device):
        trainer, state = vqgan_state(cfg, device, seed)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        return trainer, state, on

    def witness(ids_calls):
        trainer, state, on = fresh("cpu")
        to_float64(state.decoder, state.discriminator)
        with float64_step(ids_calls):
            trainer.train_step(state, images, draws=on)
        return first_moments(state, parts)

    def run(name, device, use_cudnn, nudge, use_mkldnn):
        trainer, state, on = fresh(device)
        with torch.no_grad():
            x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
            vqgan = state.decoder.eval()
            feats = vqgan.encoder(x).permute(0, 2, 3, 1)
            ids = vqgan(x, train=False)[2]
        prev_cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = use_cudnn
        try:
            with ulp_nudged_quantization(seed) if nudge else contextlib.nullcontext(), \
                    recorded_vq_ids() as seen, torch.backends.mkldnn.flags(enabled=use_mkldnn):
                _, metrics = trainer.train_step(state, images, draws=on)
        finally:
            torch.backends.cudnn.enabled = prev_cudnn
        return SimpleNamespace(feats=feats.cpu(), ids=ids.cpu(), vq_ids=seen,
                               m={k: float(v) for k, v in metrics.items()},
                               grads=first_moments(state, parts),
                               vq=[t.cpu() for t in state.vq])

    def card_runs(card):
        runs = [("card", (True, False, True))]
        if torch.device(card).type == "cuda":
            runs += [("card_no_cudnn", (False, False, True)), ("card_ulp", (True, True, True))]
        return runs

    return SimpleNamespace(setup=setup, start=start, parts=parts, witness=witness, run=run,
                           cpu_runs=[("cpu", (True, False, True)),
                                     ("cpu_native", (True, False, False))],
                           card_runs=card_runs)


def vqgan_reference_check(handle, witnesses):
    """The vqgan part's checks and record (see `vqgan_reference_context`)."""
    from medical_image_editing_tpu_torch.ops.vq import vq_scores
    from medical_image_editing_tpu_torch.utils.witness import (
        witness_gaps,
        witness_limits,
    )

    ctx, out, parts = handle.ctx, handle.out, handle.ctx.parts
    cpu, c = out["cpu"], out["card"]
    top2 = vq_scores(ctx.start["decoder"]["vq.embed"],
                     cpu.feats.reshape(-1, cpu.feats.shape[-1])).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-4 * top2.abs().max()).reshape(cpu.ids.shape)
    id_mismatch = int(((c.ids != cpu.ids) & clear).sum())
    loss_err = {k: abs(c.m[k] - v) / max(abs(v), 1e-6) for k, v in cpu.m.items()}
    codebook_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
                       for a, b in zip(c.vq, cpu.vq))
    # the one-ulp run's step is another function (its features moved): a
    # readout against the card only
    gaps, n_witness = witness_gaps({k: v for k, v in out.items() if k != "card_ulp"},
                                   ctx.witness, parts, witnesses)
    floor, grad_limit = witness_limits(gaps, WITNESS_MINIMUM["vqgan"],
                                       WITNESS_CAP["vqgan"])
    grad_err = gaps["card"]
    readouts = {name: {m: float((o.grads[m] - cpu.grads[m]).norm() / cpu.grads[m].norm())
                       for m, _ in parts}
                for name, o in out.items() if name.startswith("card")}
    variants = {name: {m: float((o.grads[m] - g).norm() / g.norm())
                       for m, g in c.grads.items()}
                for name, o in out.items() if name.startswith("card_")}
    rec = {"phase": "vqgan", "part": "reference", "card": handle.card, "size": handle.size,
           "batch": handle.batch,
           "id_mismatches_clear": id_mismatch, "clear_share": float(clear.float().mean()),
           "loss_rel_err": loss_err, "grad_rel_err_vs_f64": gaps, "grad_floor": floor,
           "grad_limit": grad_limit, "witnesses": n_witness,
           "readout_grad_rel_err_vs_cpu": readouts, "readout_card_variants": variants,
           "codebook_rel_err": codebook_err, "losses_cpu": cpu.m, "losses_card": c.m,
           **handle.timing,
           "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; losses and "
                        "the codebook rtol 1e-3; gradients (Adam's first moment): the card's "
                        "distance from a float64 CPU step on its own ids within 5x the larger "
                        "of the CPU's two float32 steps' (oneDNN, native) or 1e-4, at most "
                        "WITNESS_CAP (relative Frobenius; cuDNN off, one-ulp features and "
                        "the distance from the CPU readouts)"}
    emit(rec)
    if id_mismatch or max(loss_err.values()) > 1e-3 or codebook_err > 1e-3 or any(
            grad_err[m] > grad_limit[m] for m in grad_err):
        raise RuntimeError(f"card vs CPU VQGAN step: {id_mismatch} clear id mismatches, loss "
                           f"errors {loss_err}, codebook {codebook_err}, gradient errors "
                           f"against float64 {gaps} (limits {grad_limit})")


REFERENCE_KINDS = {"second_stage": second_stage_reference_context,
                   "multi_window": multi_window_reference_context,
                   "vqgan": vqgan_reference_context, "prior": prior_reference_context}
REFERENCE_CHECKS = {"second_stage": second_stage_reference_check,
                    "multi_window": multi_window_reference_check,
                    "vqgan": vqgan_reference_check, "prior": prior_reference_check}


def finish_or_defer(handle, defer):
    """`finish_reference(handle)` now, or, when `defer` is a list, append
    the handle to it for the caller to finish."""
    if defer is None:
        finish_reference(handle)
    else:
        defer.append(handle)


@contextlib.contextmanager
def ulp_nudged_quantization(seed=0):
    """Inside the block the quantized features (the VQGAN's, and the
    encoder's of the other models) move by one ulp up or down at random
    (the gradient still flows straight through)."""
    import torch

    from medical_image_editing_tpu_torch.models import unet_encoder as tenc
    from medical_image_editing_tpu_torch.models import vqgan as tvqgan

    real, gens = tvqgan.vq_apply, {}

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        gen = gens.setdefault(q.device, torch.Generator(device=q.device).manual_seed(seed))
        up = torch.randint(0, 2, q.shape, generator=gen, device=q.device).bool()
        moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
        return (q + (moved - q).detach(), *rest)

    tvqgan.vq_apply = tenc.vq_apply = nudged
    try:
        yield
    finally:
        tvqgan.vq_apply = tenc.vq_apply = real


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
    maps. Launches are held to the derived counts. Off the counted path, two
    planted faults, each B's step-3 save resumed to 6: the codebook's EMA
    buffers dropped (counts 0, sums = the codebook), which the limits as a
    whole must catch, and the discriminator's Adam moments dropped, which
    the discriminator's limits alone must catch; their gaps are printed
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

    # -- the planted faults, off the counted path: B's step-3 save with the
    # codebook's EMA buffers dropped, and with the discriminator's Adam
    # moments dropped, each resumed to 6
    def planted_gap_of(name, plant):
        return state_gap(final_a, planted_run(
            run, name, ["-m", "train", "--max-steps", str(total)],
            run_b / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003", plant, last))

    def drop_codebook_ema(state):
        vq = state["decoder"]
        vq["vq.cluster_size"] = torch.zeros_like(vq["vq.cluster_size"])
        vq["vq.embed_avg"] = vq["vq.embed"].t().clone()

    def drop_dis_moments(state):
        state["dis_opt"]["state"] = {}

    planted_gap = planted_gap_of("vC", drop_codebook_ema)
    planted_dis_gap = planted_gap_of("vD", drop_dis_moments)
    rec = {
        "phase": "vqgan", "part": "run", "device": str(device), "size": size, "batch": batch,
        "steps": total, "steps_per_epoch": steps_per_epoch, "slices": n_slices,
        "launches": launches, "launches_expected": want, "path_s": path_s,
        "fit_step_s": warm, "fit_step_s_median": float(np.median(warm)) if warm else None,
        "same_batch_stream": same_stream, "counters": counters, "resume_gap": gap,
        "resume_gap_limit": VQGAN_RESUME_GAP_LIMIT, "planted_fault_gap": planted_gap,
        "planted_dis_fault_gap": planted_dis_gap,
        "validation_grids": len(grids), "result_csv": result,
        "label_maps": len(labels), "label_shape": list(np.shape(label_ids)),
        "label_range": [int(label_ids.min()), int(label_ids.max())] if labels else None,
        "checkpoint_bytes": os.path.getsize(run_a / "version_0" / "ckpt" / last / "state.pt"),
        "max_memory_allocated_bytes": peak, "card": nvidia_smi() if cuda else None,
    }
    emit(rec)

    def within(g, parts=tuple(VQGAN_RESUME_GAP_LIMIT)):
        return all(g[part][k] <= limit for part in parts
                   for k, limit in VQGAN_RESUME_GAP_LIMIT[part].items())

    checks = {
        "same_batch_stream": same_stream,
        "counters": counters["A"] == counters["B"] == (total, 1),
        "resume_gap": within(gap), "planted_fault_caught": not within(planted_gap),
        "planted_dis_fault_caught": not within(planted_dis_gap, ("discriminator",)),
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


def losses_phase(device, workdir, *, size=256, batch=8, steps=3, seed=0, overrides=None,
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


# --------------------------------------------------------------------------
# the volumetric VQ-WNet (`train_volumetric`, `edit_volume`)
# --------------------------------------------------------------------------

VOL_FILTERS = (8, 16, 32, 64)  # BASELINE config #5, the JAX CLIs' default
VOL_DICT_SIZE = 10


def volumetric_flops(enc, dec, batch, size):
    """Operations of the encoder's and decoder's forward and backward at
    (batch, 1, size³), counted by `torch.utils.flop_counter` on the meta
    device (the convolutions; the VQ assignment, 3·N·K·C, aside; with
    remat the recomputed forwards count): (forward and backward, forward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    menc, mdec = copy.deepcopy(enc).to("meta"), copy.deepcopy(dec).to("meta")
    x = torch.zeros(batch, 1, size, size, size, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        mdec(menc(x))
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        mdec(menc(x)).sum().backward()
    return fc.get_total_flops(), fwd


def volumetric_phase(device, workdir, *, size=128, batch=2, steps=3, filters=VOL_FILTERS,
                     dict_size=VOL_DICT_SIZE, ref_size=32, cli_steps=3, n_synthetic=4,
                     shard_steps=3, seed=0):
    """The volumetric VQ-WNet at BASELINE config #5's widths (filters
    8,16,32,64, `dict_size` 10, 128³, batch 2): (a) bare steps in f32 and in
    bf16 with remat, (b) `train_volumetric.main` and `edit_volume.main`
    in-process, (c) one step held to the CPU path at `ref_size`³, (e) the
    depth-sharded step and decode (`volumetric_sharded_part`: VOL_MESH
    gloo ranks sharing the card, `shard_steps` steps), (d) both kernels'
    launches held at 0 on (a), (b) and (e), which are the main path.
    The synthetic volumes are made once: (a) trains on the first `batch`,
    which are also the CLI's first (the same seeded draws), and its steps
    are the one-process steps (e) is held to (the same seeded weights).
    Returns the launches of (a), (b) and (e)."""
    from medical_image_editing_tpu_torch.cli.train_volumetric import _synthetic_volumes

    vols = _synthetic_volumes(batch, size, seed)
    launches, refs = volumetric_step_part(device, vols, steps=steps, filters=filters,
                                          dict_size=dict_size, seed=seed)
    run = volumetric_cli_part(device, workdir, vols[:1], steps=cli_steps,
                              n_synthetic=n_synthetic, batch=batch, filters=filters,
                              dict_size=dict_size, seed=seed)
    volumetric_reference_part(size=ref_size, batch=batch, filters=filters,
                              dict_size=dict_size, seed=seed + 1, card=device, norm_size=size)
    sharded = volumetric_sharded_part(device, workdir, size=size, batch=batch, steps=shard_steps,
                                      filters=filters, dict_size=dict_size, seed=seed, refs=refs)
    for k, v in [*run.items(), *sharded.items()]:
        launches[k] = launches.get(k, 0) + v
    if any(launches.values()):
        raise RuntimeError(f"the volumetric path launched hand-written kernels: {launches} "
                           "(it runs the plain VQ assignment and cuDNN's conv3d)")
    return launches


def volumetric_step_part(device, vols, *, steps, filters, dict_size, seed):
    """(a) `init_volumetric` and `steps` bare steps of
    `make_volumetric_train_step` on `vols` (B, D, H, W, 1), in f32 and in
    bf16 with remat (the JAX package's memory plan), each from the same
    seeded weights: warm step time, peak memory, the losses; on the card
    a profiled warm step (busy as the union of the kernels' intervals, idle
    share, top kernels) and the rate against the operations counted from
    the model, and f32 steps timed under TF32 and `cudnn.benchmark`
    (`f32_step_variants`); the bf16 losses' gap to f32's after the same
    steps. Returns the launches and, by mode, each step's losses and
    codebook and the first step's gradients (the one-process steps
    `volumetric_sharded_part` holds the sharded ones to)."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.volumetric import (
        init_volumetric,
        make_volumetric_train_step,
    )

    cuda = torch.device(device).type == "cuda"
    batch, size = vols.shape[0], vols.shape[1]
    x = torch.as_tensor(vols, device=device)
    launches, recs, refs = {}, {}, {}
    for name, dtype, remat in (("f32", None, False), ("bf16_remat", torch.bfloat16, True)):
        enc, dec, vq, eo, do = init_volumetric(
            torch.Generator().manual_seed(seed), filters=filters, dict_size=dict_size,
            volume_shape=vols.shape, dtype=dtype, use_remat=remat, device=device)
        step = make_volumetric_train_step(enc, dec, eo, do)
        flops, fwd = volumetric_flops(enc, dec, batch, size)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        # -- main path: the steps
        step_s, losses, codebooks = [], [], []
        for n in range(steps):
            t0 = time.perf_counter()
            vq, m = step(vq, x)
            if cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in m.items()})
            codebooks.append({"cluster_size": vq.cluster_size.cpu(), "embed": vq.embed.cpu()})
            if n == 0:
                grads = {part: torch.cat([p.grad.flatten() for p in module.parameters()]).cpu()
                         for part, module in (("enc", enc), ("dec", dec))}
        refs[name] = {"losses": losses, "vq": codebooks, "grads": grads}
        for k, v in _build.launches.items():
            launches[k] = launches.get(k, 0) + v
        warm = float(np.median(step_s[1:] or step_s))
        rec = {"phase": "volumetric", "part": "step", "mode": name, "device": str(device),
               "size": size, "batch": batch, "filters": list(filters), "dict_size": dict_size,
               "steps": steps, "parameters": sum(p.numel() for p in enc.parameters())
               + sum(p.numel() for p in dec.parameters()),
               "launches": dict(_build.launches), "step_s": step_s, "warm_step_s_median": warm,
               "losses_first": losses[0], "losses_last": losses[-1],
               "step_flop": flops, "forward_flop": fwd,
               "step_f32_floor_s": flops / PEAK_F32_FLOP_PER_S,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated() if cuda else None}
        if cuda:
            wall, kernels, union = profile_union(lambda: step(vq, x))
            rec["profile"] = kernel_breakdown(wall, kernels, 10)
            rec["device_busy_union_s"] = union
            rec["device_idle_share_of_warm_step"] = 1.0 - union / warm
            rec["achieved_flop_per_s"] = flops / union
            rec["share_of_f32_peak"] = flops / union / PEAK_F32_FLOP_PER_S
            rec["card"] = nvidia_smi()
        if cuda and dtype is None:
            rec["f32_variants"] = f32_step_variants(lambda: step(vq, x))
        recs[name] = rec
        del enc, dec, vq, eo, do, step
        if cuda:
            torch.cuda.empty_cache()
    last = {n: r["losses_last"] for n, r in recs.items()}
    recs["bf16_remat"]["loss_rel_gap_to_f32"] = {
        k: abs(last["bf16_remat"][k] - v) / max(abs(v), 1e-12) for k, v in last["f32"].items()}
    if cuda:
        recs["bf16_remat"]["peak_vs_f32"] = (recs["bf16_remat"]["max_memory_allocated_bytes"]
                                             / recs["f32"]["max_memory_allocated_bytes"])
    for rec in recs.values():
        emit(rec)
    bad = {n: r["losses_last"] for n, r in recs.items()
           if not all(np.isfinite(v) for v in r["losses_last"].values())}
    if bad:
        raise RuntimeError(f"volumetric steps: losses not finite {bad}")
    return launches, refs


def f32_step_variants(run_step, steps=2):
    """Time `steps` more f32 steps (`run_step` runs one; the model trains
    on) under cuDNN's TF32 (the CLIs' default precision) and, apart, under
    `cudnn.benchmark` (cuDNN times its algorithms on the first call of
    each shape): the host-clock step times, synchronised, and the median
    of all but the first. The flags are restored after each."""
    import torch

    out = {}
    for name, flag in (("tf32", "allow_tf32"), ("cudnn_benchmark", "benchmark")):
        prev = getattr(torch.backends.cudnn, flag)
        setattr(torch.backends.cudnn, flag, True)
        try:
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                run_step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            setattr(torch.backends.cudnn, flag, prev)
        out[name] = {"step_s": times, "warm_step_s_median": float(np.median(times[1:]))}
    tf32_off()
    return out


def volumetric_cli_part(device, workdir, vol, *, steps, n_synthetic, batch, filters,
                        dict_size, seed):
    """(b) The CLIs as a user runs them, in-process under
    MEDIMG_CONV_PRECISION=ieee (TF32 checked off after each):
    `train_volumetric.main` on `n_synthetic` seeded volumes, `steps` steps
    (the step lines, the checkpoint, `recon_mid.png`); `vol` (1, D, H, W, 1)
    encoded with the trained weights, a sub-box of its ids painted to
    another code, and decoded through `edit_volume.main` from `.npy`,
    `.nii.gz` and with `--uint8`; the time per decoded volume; a painted
    label of dict_size + 1 refused. Returns the launches."""
    import io

    import torch

    from medical_image_editing_tpu_torch.cli import edit_volume, train_volumetric
    from medical_image_editing_tpu_torch.models.volumetric import (
        VolumetricUNetEncoder,
        volumetric_forward,
    )
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    cuda = torch.device(device).type == "cuda"
    size = vol.shape[1]
    out = Path(workdir) / "volumetric"
    dev_args = [] if cuda else ["--device", "cpu"]
    fl = ",".join(str(f) for f in filters)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    _build.launches.clear()
    # -- main path: train, then the edits
    buf = io.StringIO()
    with conv_precision("ieee"), contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        rc = train_volumetric.main(
            ["--size", str(size), "--batch", str(batch), "--n-synthetic", str(n_synthetic),
             "--steps", str(steps), "--filters", fl, "--dict-size", str(dict_size),
             "--log-every", "1", "--seed", str(seed), "--out", str(out), *dev_args])
        sync()
        train_s = time.perf_counter() - t0
        tf32_off()
    step_lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step ")]
    ckpt = out / "volumetric_ckpt"
    sd = load_state_file(str(ckpt))
    enc = VolumetricUNetEncoder(filters=filters)
    enc.load_state_dict(sd["enc"])
    decoder, vq = edit_volume.load_volumetric_checkpoint(str(ckpt), filters=filters,
                                                         dict_size=dict_size, device=device)
    with torch.no_grad():
        _, _, ids, _ = volumetric_forward(enc.to(device), decoder, vq,
                                          torch.as_tensor(vol, device=device), train=False)
    del enc
    ids = ids[0].cpu().numpy().astype(np.int32)
    box = slice(size // 4, size // 2)
    codes, counts = np.unique(ids[box, box, box], return_counts=True)
    label = 1 + int(codes[np.argmax(counts)]) % dict_size  # another code than the box's most
    painted = ids.copy()
    painted[box, box, box] = label
    labels = out / "labels"
    labels.mkdir()
    np.save(labels / "vol_a.npy", painted)
    nifti.save(np.transpose(painted, (2, 1, 0)).astype(np.float64), str(labels / "vol_b.nii.gz"))

    def edit_main(label_dir, name, *extra):
        return edit_volume.main(["--ckpt", str(ckpt), "--labels", str(label_dir),
                                 "--out", str(out / f"edited_{name}"), "--filters", fl,
                                 "--dict-size", str(dict_size), *dev_args, *extra])

    edit_s = {}
    with conv_precision("ieee"), contextlib.redirect_stdout(io.StringIO()):
        for name, extra in (("f32", []), ("uint8", ["--uint8"])):
            t0 = time.perf_counter()
            if edit_main(labels, name, *extra) != 0:
                raise RuntimeError(f"edit_volume {name} failed")
            sync()
            edit_s[name] = time.perf_counter() - t0
        tf32_off()
        bad = out / "bad"
        bad.mkdir()
        wrong = painted.copy()
        wrong[0, 0, 0] = dict_size + 1
        np.save(bad / "vol_bad.npy", wrong)
        try:
            edit_main(bad, "bad")
            refused = False
        except ValueError as e:
            refused = "painted labels" in str(e)
    launches = dict(_build.launches)

    rec_a = np.load(out / "edited_f32" / "edited_vol_a.npy")
    rec_b = np.transpose(nifti.load(str(out / "edited_f32" / "edited_vol_b.nii.gz")), (2, 1, 0))
    u8 = np.load(out / "edited_uint8" / "edited_vol_a.npy")
    edit = edit_volume.make_volumetric_edit_fn(decoder, device=device)
    one = painted[None]
    t0 = time.perf_counter()
    direct = edit(vq, one)
    sync()
    first_s = time.perf_counter() - t0
    split = edit_split(edit_volume, decoder, vq, labels, out / "split", device)
    rec = {"phase": "volumetric", "part": "run", "device": str(device), "size": size,
           "batch": batch, "steps": steps, "n_synthetic": n_synthetic, "rc": rc,
           "step_lines": step_lines, "train_main_s": train_s,
           "checkpoint_bytes": (ckpt / "state.pt").stat().st_size,
           "recon_png_bytes": (out / "recon_mid.png").stat().st_size,
           "codes_in_encoded_volume": int(len(np.unique(ids))), "painted_label": label,
           "painted_box": [box.start, box.stop], "edit_main_s": edit_s,
           "edit_main_s_per_volume": {k: v / 2 for k, v in edit_s.items()},
           "edit_fn_s": first_s, "edit_split_s": split, "launches": launches,
           "decoded_range": [float(rec_a.min()), float(rec_a.max())],
           "nii_vs_npy_max_abs": float(np.abs(rec_b - rec_a).max()),
           "uint8_vs_f32_max_level": int(np.abs(
               u8.astype(np.int32) - ((np.clip(rec_a, -1, 1) + 1) * 127.5).astype(np.int32)).max()),
           "direct_vs_cli_max_abs": float(np.abs(direct[0].cpu().numpy() - rec_a).max()),
           "out_of_range_label_refused": refused}
    if cuda:
        rec["edit_fn_ms"] = cuda_ms(lambda: edit(vq, one), warmup=1, iters=3)
        rec["card"] = nvidia_smi()
    emit(rec)
    checks = {"rc": rc == 0, "step_lines": len(step_lines) == steps,
              "checkpoint": rec["checkpoint_bytes"] > 0, "png": rec["recon_png_bytes"] > 0,
              "shape": rec_a.shape == (size,) * 3 and u8.dtype == np.uint8,
              "finite": bool(np.isfinite(rec_a).all()) and abs(rec_a).max() <= 1.0,
              "nii": rec["nii_vs_npy_max_abs"] <= 1e-6, "uint8": rec["uint8_vs_f32_max_level"] <= 1,
              "direct": rec["direct_vs_cli_max_abs"] <= 1e-4, "refused": refused}
    if not all(checks.values()):
        raise RuntimeError(f"volumetric CLIs: {checks}")
    return launches


def edit_split(edit_volume, decoder, vq, labels, out, device):
    """The parts of `edit_volume.main`'s time per volume, each timed apart
    on the host clock: reading the painted ids from .npy and .nii.gz, the
    decode (synchronised) in float32 and as uint8, and writing each
    decoded volume as .npy and as .nii.gz."""
    import torch

    def timed(fn):
        t0 = time.perf_counter()
        r = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    out.mkdir()
    split = {}
    ids = None
    for ext, src in (("npy", "vol_a.npy"), ("nii_gz", "vol_b.nii.gz")):
        ids, split[f"read_{ext}"] = timed(lambda: edit_volume._load_label_volume(
            str(labels / src)))
    for dt in ("f32", "uint8"):
        fn = edit_volume.make_volumetric_edit_fn(
            decoder, output_dtype="uint8" if dt == "uint8" else None, device=device)
        rec, split[f"decode_{dt}"] = timed(lambda: fn(vq, ids[None]).cpu().numpy()[0])
        for ext, suffix in (("npy", ".npy"), ("nii_gz", ".nii.gz")):
            _, split[f"write_{dt}_{ext}"] = timed(lambda: edit_volume._save_volume(
                str(out / f"edited_{dt}{suffix}"), rec))
    return split


def volumetric_grads_f64(enc, dec, embed, vols, ids):
    """The gradients of the volumetric step's loss (reconstruction MSE plus
    commit, as `make_volumetric_train_step`) in float64 on the CPU, from
    copies of `enc` and `dec`, the codebook `embed` and the code of each
    voxel `ids` (B, D, H, W) from 0: the witness that the card's and the
    CPU's float32 gradients are held to. The ids are given, not recomputed:
    a voxel whose top two codes tie at float32 rounding may take the other
    code in float64, and at random init one such voxel moves the decoder's
    gradient by percents. The instance norm and the tanh stay in float64
    here (the model takes them in float32). Returns {"enc", "dec"}: each
    module's parameter gradients, flattened and concatenated in
    `parameters()` order."""
    import torch
    import torch.nn.functional as F

    from medical_image_editing_tpu_torch.models import volumetric as tvol

    enc = copy.deepcopy(enc).cpu().double()
    dec = copy.deepcopy(dec).cpu().double()
    real = tvol.instance_norm_3d
    tvol.instance_norm_3d = lambda x, mesh=None: F.instance_norm(x, eps=1e-5)
    try:
        x = torch.as_tensor(np.asarray(vols), dtype=torch.float64).permute(0, 4, 1, 2, 3)
        feats = enc(x)
        rows = feats.permute(0, 2, 3, 4, 1).reshape(-1, feats.shape[1])
        q = embed.detach().cpu().double()[ids.flatten().long().cpu()]
        commit = ((rows - q) ** 2).mean()
        q_st = (rows + (q - rows).detach()).reshape(
            feats.shape[0], *feats.shape[2:], feats.shape[1]).permute(0, 4, 1, 2, 3)
        recon = torch.tanh(dec.Conv_0(dec.body(q_st)))
        (((recon - x) ** 2).mean() + commit).backward()
    finally:
        tvol.instance_norm_3d = real
    return {m: torch.cat([p.grad.flatten() for p in mod.parameters()])
            for m, mod in (("enc", enc), ("dec", dec))}


def volumetric_reference_part(*, size=32, batch=2, filters=VOL_FILTERS,
                              dict_size=VOL_DICT_SIZE, seed=1, card="cuda", norm_size=128):
    """One f32 volumetric step on the card vs the same step on the port's
    CPU path, at full widths on `size`³ volumes, from the same seeded
    weights, TF32 asserted off. Held: the ids where the top-2 score gap is
    clear of rounding, the losses (rtol 1e-3), the codebook after the step
    (rtol 1e-3), the parameters after the step within 2·lr of the CPU's
    (Adam's first step moves each by at most lr), and the gradients
    (relative Frobenius norm per module) against a witness that does not
    depend on the card: the step in float64 on the CPU from each run's own
    ids (`volumetric_grads_f64`). The card's distance from it is held
    within 5× the CPU's, or 1e-5, the CPU's read on both of its float32
    convolutions (oneDNN's and PyTorch's native ones) and the larger
    taken: the max-pools see exact ties (at 32³, seed 1: some 7,000
    windows of the decoder's first block, on its piecewise-constant
    codebook input, and about ten of the encoder's), which two float32
    convolutions break at different voxels, each moving the gradient by a
    step of its own. The card's step again with cuDNN off is a readout.
    Also the card's instance norm at the phase's level-0 shape (2 × 8
    channels of `norm_size`³ voxels: 2²¹ at 128³) against float64 on the
    CPU. `card` "cpu" rehearses the comparison."""
    import torch
    import torch.nn.functional as F

    from medical_image_editing_tpu_torch.cli.train_volumetric import _synthetic_volumes
    from medical_image_editing_tpu_torch.models import volumetric as tvol
    from medical_image_editing_tpu_torch.ops.vq import VQState, vq_scores
    from medical_image_editing_tpu_torch.train.volumetric import (
        init_volumetric,
        make_volumetric_train_step,
    )

    tf32_off()  # held to the CPU at full f32
    lr = 1e-4
    vols = _synthetic_volumes(batch, size, seed)
    enc, dec, vq0, _, _ = init_volumetric(torch.Generator().manual_seed(seed), filters=filters,
                                          dict_size=dict_size, volume_shape=vols.shape,
                                          lr=lr, device="cpu")
    start = (copy.deepcopy(enc.state_dict()), copy.deepcopy(dec.state_dict()))
    runs = [("cpu", "cpu", True, True), ("cpu_native", "cpu", True, False),
            ("card", card, True, True)]
    if card == "cuda":
        runs += [("card_no_cudnn", card, False, True)]
    out, witness = {}, {}
    for name, device, use_cudnn, use_mkldnn in runs:
        enc_r, dec_r, _, eo, do = init_volumetric(torch.Generator(), filters=filters,
                                                  dict_size=dict_size, volume_shape=vols.shape,
                                                  lr=lr, device=device)
        enc_r.load_state_dict(start[0])
        dec_r.load_state_dict(start[1])
        vq = VQState(*(t.to(device) for t in vq0))
        x = torch.as_tensor(vols, device=device)
        prev_cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = use_cudnn
        try:
            with (contextlib.nullcontext() if use_mkldnn
                  else torch.backends.mkldnn.flags(enabled=False)):
                with torch.no_grad():
                    feats = enc_r(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
                    ids = tvol.volumetric_forward(enc_r, dec_r, vq, x, train=False)[2].cpu()
                new_vq, metrics = make_volumetric_train_step(enc_r, dec_r, eo, do)(vq, x)
        finally:
            torch.backends.cudnn.enabled = prev_cudnn
        grads = {m: torch.cat([p.grad.flatten().cpu() for p in mod.parameters()])
                 for m, mod in (("enc", enc_r), ("dec", dec_r))}
        params = {m: torch.cat([p.detach().flatten().cpu() for p in mod.parameters()])
                  for m, mod in (("enc", enc_r), ("dec", dec_r))}
        key = hashlib.sha1(ids.numpy().tobytes()).hexdigest()
        if key not in witness:
            witness[key] = volumetric_grads_f64(enc, dec, vq0.embed, vols, ids - 1)
        out[name] = SimpleNamespace(
            feats=feats.cpu(), ids=ids, m={k: float(v) for k, v in metrics.items()},
            grads=grads, vq=[t.cpu() for t in new_vq], params=params,
            vs_f64={m: float((g.double() - witness[key][m]).norm() / witness[key][m].norm())
                    for m, g in grads.items()})
        del enc_r, dec_r, eo, do
    cpu, c = out["cpu"], out["card"]
    top2 = vq_scores(vq0.embed, cpu.feats.reshape(-1, cpu.feats.shape[-1])).topk(2, dim=1)
    clear = ((top2.values[:, 0] - top2.values[:, 1]) > 1e-4 * top2.values.abs().max()
             ).reshape(cpu.ids.shape)
    id_mismatch = int(((c.ids != cpu.ids) & clear).sum())
    loss_err = {k: abs(c.m[k] - v) / max(abs(v), 1e-6) for k, v in cpu.m.items()}
    grad_vs_f64 = {name: o.vs_f64 for name, o in out.items()}
    grad_err = c.vs_f64
    grad_floor = {m: max(out["cpu"].vs_f64[m], out["cpu_native"].vs_f64[m]) for m in grad_err}
    grad_limit = {m: max(5 * f, 1e-5) for m, f in grad_floor.items()}
    grad_card_vs_cpu = {m: float((c.grads[m] - g).norm() / g.norm())
                        for m, g in cpu.grads.items()}
    codebook_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
                       for a, b in zip(c.vq, cpu.vq))
    param_gap = {m: {"max_lr": float((c.params[m] - p).abs().max()) / lr,
                     "share_over_1e-3_lr": float(((c.params[m] - p).abs() > 1e-3 * lr)
                                                 .float().mean())}
                 for m, p in cpu.params.items()}
    # instance norm over norm_size³ voxels a channel, offset channel means:
    # the card's f32 and the CPU's f32 against float64
    g = torch.Generator().manual_seed(seed)
    act = torch.randn(2, 8, norm_size, norm_size, norm_size, generator=g) * 0.05 + \
        torch.linspace(-3, 3, 8)[None, :, None, None, None]
    ref64 = F.instance_norm(act.double(), eps=1e-5)
    in_err = {"cpu": float((tvol.instance_norm_3d(act).double() - ref64).abs().max())}
    if card != "cpu":
        in_err["card"] = float((tvol.instance_norm_3d(act.to(card)).cpu().double()
                                - ref64).abs().max())
    del act, ref64
    rec = {"phase": "volumetric", "part": "reference", "card": card, "size": size,
           "batch": batch, "filters": list(filters), "id_mismatches_clear": id_mismatch,
           "clear_share": float(clear.float().mean()), "loss_rel_err": loss_err,
           "grad_rel_err_vs_f64": grad_vs_f64, "grad_floor": grad_floor,
           "grad_limit": grad_limit, "grad_card_vs_cpu": grad_card_vs_cpu,
           "witnesses": len(witness), "codebook_rel_err": codebook_err,
           "param_gap": param_gap, "losses_cpu": cpu.m, "losses_card": c.m,
           "instance_norm_size": norm_size, "instance_norm_max_abs_err_vs_f64": in_err,
           "tolerance": "ids equal where the top-2 score gap > 1e-4·max|score|; losses and "
                        "the codebook rtol 1e-3; gradients: the card's distance from a "
                        "float64 CPU step on its own ids within 5x the larger of the CPU's "
                        "two float32 steps' (oneDNN, native) or 1e-5 (relative Frobenius; "
                        "cuDNN off a readout); parameters within 2·lr; instance norm "
                        "within 1e-4 of float64"}
    emit(rec)
    if (id_mismatch or max(loss_err.values()) > 1e-3 or codebook_err > 1e-3
            or any(grad_err[m] > grad_limit[m] for m in grad_err)
            or any(v["max_lr"] > 2.0 + 1e-3 for v in param_gap.values())
            or max(in_err.values()) > 1e-4):
        raise RuntimeError(f"card vs CPU volumetric step: {id_mismatch} clear id mismatches, "
                           f"loss errors {loss_err}, codebook {codebook_err}, gradient "
                           f"errors against float64 {grad_vs_f64} (limits {grad_limit}), "
                           f"parameters {param_gap}, instance norm {in_err}")


# --------------------------------------------------------------------------
# volumetric depth sharding (`train_volumetric --mesh`, `edit_volume
# --partition spatial`): gloo ranks sharing the card
# --------------------------------------------------------------------------

VOL_MESH = (2, 2)  # data × spatial: at 128³ and batch 2, one volume and 64 slabs a rank
VOL_SHARD_MODES = {"f32": (None, False), "bf16_remat": ("bfloat16", True)}
# Each limit, step by step, is VOL_SHARD_LIMIT_FACTOR × the largest gap of
# a spread of readings taken in the same run: the one-process steps
# perturbed at the rounding level (`volumetric_nudged`: the encoder's input
# and the quantized features moved by one ulp of their dtype, at each seed
# of VOL_SHARD_SPREAD) against the one-process steps, at least
# VOL_SHARD_LIMIT_MIN. After the first step the states part (Adam's
# first step is ±lr wherever |g| ≫ 1e-8, so elements whose gradient
# differs at the rounding level turn), and the spread says how far. The
# planted fault (the halo exchange returning zeros) must land
# VOL_SHARD_FAULT_MARGIN × above the first step's limits of the decoder
# gradient and of the total loss (on an NVIDIA H100 80GB HBM3 at 700 W, 128³:
# 4.6× and 88×; the decoder gradient's limit is set by the ties of its max-pools,
# which a one-ulp change breaks elsewhere: 0.9% in the spread, 0.5%
# sharded, 21% with the fault).
VOL_SHARD_SPREAD = (1, 2, 3)
VOL_SHARD_LIMIT_FACTOR = 5.0
VOL_SHARD_LIMIT_MIN = 1e-6
VOL_SHARD_FAULT_MARGIN = 3.0
VOL_SHARD_GAPS = ("total", "recon", "commit", "cluster_size", "embed", "enc_grad", "dec_grad")
VOL_SHARD_GO_TIMEOUT_S = 600


def ulp_nudge(x, generator, dtype=None):
    """`x` moved by one ulp of `dtype` (x's own by default) up or down at
    random, in x's dtype."""
    import torch

    y = x.to(dtype or x.dtype)
    up = torch.randint(0, 2, y.shape, generator=generator, device=y.device).bool()
    return torch.where(up, torch.nextafter(y, y + 1), torch.nextafter(y, y - 1)).to(x.dtype)


@contextlib.contextmanager
def volumetric_nudged(seed, encoder):
    """Inside the block the volumetric step is perturbed at the rounding
    level: the encoder's input moves by one ulp of its compute dtype, and
    the quantized features by one ulp of theirs (the gradient still flows
    straight through), each up or down at random."""
    import torch

    from medical_image_editing_tpu_torch.models import volumetric as tvol

    real, gens = tvol.vq_apply, {}

    def gen(device):
        return gens.setdefault(device, torch.Generator(device=device).manual_seed(seed))

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        return (q + (ulp_nudge(q, gen(q.device)) - q).detach(), *rest)

    hook = encoder.register_forward_pre_hook(
        lambda m, args: (ulp_nudge(args[0], gen(args[0].device), m.compute_dtype),))
    tvol.vq_apply = nudged
    try:
        yield
    finally:
        tvol.vq_apply = real
        hook.remove()


@contextlib.contextmanager
def zero_halos():
    """The planted fault: inside the block every depth halo exchange
    returns zeros (forward and backward)."""
    import torch

    from medical_image_editing_tpu_torch.parallel import spatial

    real = spatial._exchange
    spatial._exchange = lambda sends, group: {p: torch.zeros_like(t) for p, t in sends.items()}
    try:
        yield
    finally:
        spatial._exchange = real


def vol_shard_steps(mesh, vols, *, mode, steps, filters, dict_size, seed, device, nudge=None):
    """`steps` steps of `make_volumetric_train_step(mesh=mesh)` from the
    seeded weights on this rank's block of `vols` (all of it without a
    mesh), perturbed at the rounding level with `nudge` (a seed,
    `volumetric_nudged`): each step's global losses and codebook, the first
    step's summed gradients (each module's, flattened, on the host), each
    step's collectives and bytes and its time on the host clock
    (synchronised), the peak memory."""
    import collections

    import torch

    from medical_image_editing_tpu_torch.parallel import mesh as pmesh
    from medical_image_editing_tpu_torch.train.volumetric import (
        init_volumetric,
        make_volumetric_train_step,
    )

    cuda = torch.device(device).type == "cuda"
    dtype, remat = VOL_SHARD_MODES[mode]
    enc, dec, vq, eo, do = init_volumetric(
        torch.Generator().manual_seed(seed), filters=filters, dict_size=dict_size,
        volume_shape=vols.shape, dtype=dtype and getattr(torch, dtype), use_remat=remat,
        device=device)
    step = make_volumetric_train_step(enc, dec, eo, do, mesh=mesh)
    x = torch.as_tensor(vols if mesh is None else mesh.block(vols), device=device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "vq": [], "step_s": [], "collectives": []}
    with contextlib.nullcontext() if nudge is None else volumetric_nudged(nudge, enc):
        for n in range(steps):
            before = collections.Counter(pmesh.collectives)
            t0 = time.perf_counter()
            vq, m = step(vq, x)
            if cuda:
                torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["collectives"].append(dict(collections.Counter(pmesh.collectives) - before))
            out["losses"].append({k: float(v) for k, v in m.items()})
            out["vq"].append({"cluster_size": vq.cluster_size.cpu(), "embed": vq.embed.cpu()})
            if n == 0:
                out["grads"] = {part: torch.cat([p.grad.flatten() for p in module.parameters()]).cpu()
                                for part, module in (("enc", enc), ("dec", dec))}
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    out["block"] = list(x.shape)
    return out


def vol_shard_gaps(run, ref):
    """Gaps of `run` to `ref` ({name: [per step]}; the gradients the first
    step's only): the losses relative, the codebook's `cluster_size` and
    `embed` as the largest difference over the largest value, the
    gradients as relative Frobenius norms per module."""
    gaps = {k: [] for k in VOL_SHARD_GAPS}
    for m, r, v, w in zip(run["losses"], ref["losses"], run["vq"], ref["vq"]):
        for k in ("total", "recon", "commit"):
            gaps[k].append(abs(m[k] - r[k]) / max(abs(r[k]), 1e-12))
        for k in ("cluster_size", "embed"):
            gaps[k].append(float((v[k] - w[k]).abs().max() / w[k].abs().max().clamp_min(1e-12)))
    for part in ("enc", "dec"):
        g, w = run["grads"][part].double(), ref["grads"][part].double()
        gaps[part + "_grad"].append(float((g - w).norm() / w.norm()))
    return gaps


def vol_shard_rank(rank, world, init_file, workdir, mesh_shape, steps, filters, dict_size,
                   seed, device, edit_argv):
    """One rank of the sharded part, in a process of its own: a gloo group
    (NCCL refuses several ranks on one card) through `init_file`, the
    `mesh_shape` mesh; once the parent writes `workdir/go`, `steps` steps
    in each of VOL_SHARD_MODES and one f32 step with the planted fault;
    then ranks 0 and 1 in a group of their own run `edit_volume --partition
    spatial` (f32 and uint8). Saves its records to
    `workdir/vol-shard-RANK.pt`."""
    import torch
    import torch.distributed as dist

    from medical_image_editing_tpu_torch.cli import edit_volume
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh as pmesh
    from medical_image_editing_tpu_torch.utils.device import apply_conv_precision

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    else:  # several ranks' OpenMP pools on one host spin against each other
        torch.set_num_threads(1)
    os.environ["MEDIMG_CONV_PRECISION"] = "ieee"
    apply_conv_precision()
    vols = np.load(Path(workdir) / "vols.npy")
    _build.launches.clear()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = pmesh.create_volumetric_mesh(*mesh_shape)
        kw = dict(filters=filters, dict_size=dict_size, seed=seed, device=device)
        out = {"coords": mesh.coords, "backend": dist.get_backend()}
        go, t0 = Path(workdir) / "go", time.monotonic()
        while not go.exists():  # the card is the parent's until it writes `go`
            if time.monotonic() - t0 > VOL_SHARD_GO_TIMEOUT_S:
                raise RuntimeError(f"no {go} after {VOL_SHARD_GO_TIMEOUT_S} s")
            time.sleep(0.05)
        for mode in VOL_SHARD_MODES:
            out[mode] = vol_shard_steps(mesh, vols, mode=mode, steps=steps, **kw)
        with zero_halos():
            out["halo_fault"] = vol_shard_steps(mesh, vols, mode="f32", steps=1, **kw)
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{init_file}.edit", rank=rank,
                                world_size=2)
        try:
            out["edit_s"] = {}
            for name, extra in (("f32", []), ("uint8", ["--uint8"])):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = edit_volume.main(edit_argv + extra + [
                        "--partition", "spatial", "--out", str(Path(workdir) / f"edit_{name}")])
                if rc != 0:
                    raise RuntimeError(f"edit_volume --partition spatial {name}: rc {rc}")
                out["edit_s"][name] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    out["launches"] = dict(_build.launches)
    torch.save(out, Path(workdir) / f"vol-shard-{rank}.pt")


def vol_shard_start(work, args, world):
    """`vol_shard_rank` on `world` spawned processes → the processes."""
    import torch

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=vol_shard_rank, args=(r, world, str(work / "init"), str(work),
                                                      *args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(work, procs, timeout, what="volumetric sharded", stem="vol-shard"):
    """The ranks joined within `timeout` seconds, any still alive killed →
    each rank's record (`work/STEM-RANK.pt`)."""
    import torch

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * len(procs):
        raise RuntimeError(f"{what} ranks: hung {hung}, exit codes {codes}")
    return [torch.load(work / f"{stem}-{r}.pt", weights_only=False) for r in range(len(procs))]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (the card's f32
    weight gradients are otherwise not reproducible), the flags restored
    after."""
    import torch

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def vol_shard_one_rank_part(device, work, *, size, steps, filters, dict_size, seed):
    """(iv) `train_volumetric --mesh 1,1` under a one-rank group that the
    CLI makes from a torchrun environment (NCCL on the card, gloo on the
    CPU), against the run without `--mesh` and without a group: the step
    lines, the checkpoint and the panel bit for bit (cuDNN deterministic
    in both)."""
    import torch

    from medical_image_editing_tpu_torch.cli import train_volumetric
    from medical_image_editing_tpu_torch.parallel import mesh as pmesh
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    env = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost",
               MASTER_PORT=free_port())
    dev_args = [] if torch.device(device).type == "cuda" else ["--device", "cpu"]
    fl = ",".join(str(f) for f in filters)
    lines, collectives = {}, {}
    for name in ("alone", "group"):
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(conv_precision("ieee"))
            stack.enter_context(cudnn_deterministic())
            stack.enter_context(contextlib.redirect_stdout(buf))
            extra = []
            if name == "group":
                stack.enter_context(torchrun_env(**env))
                extra = ["--mesh", "1,1"]
            pmesh.collectives.clear()
            rc = train_volumetric.main(
                ["--size", str(size), "--batch", "2", "--n-synthetic", "2", "--steps", str(steps),
                 "--filters", fl, "--dict-size", str(dict_size), "--log-every", "1",
                 "--seed", str(seed), "--out", str(work / f"one_rank_{name}"), *dev_args, *extra])
            collectives[name] = dict(pmesh.collectives)
        if rc != 0 or pmesh.is_active():
            raise RuntimeError(f"train_volumetric {name}: rc {rc}, group left {pmesh.is_active()}")
        lines[name] = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step ")]
    sds = [load_state_file(str(work / f"one_rank_{n}" / "volumetric_ckpt"))
           for n in ("alone", "group")]
    same_state = all(torch.equal(sds[0][p][k], sds[1][p][k]) for p in sds[0] for k in sds[0][p])
    pngs = [(work / f"one_rank_{n}" / "recon_mid.png").read_bytes() for n in ("alone", "group")]
    return {"step_lines": lines["group"], "same_step_lines": lines["alone"] == lines["group"],
            "same_state": same_state, "same_png": pngs[0] == pngs[1],
            "backend": "nccl" if dev_args == [] else "gloo",
            "collectives": collectives["group"]}


def volumetric_sharded_part(device, workdir, *, size, batch, steps, filters, dict_size, seed,
                            mesh_shape=VOL_MESH, one_rank_steps=2, one_rank_size=64,
                            refs=None, timeout=600):
    """The depth-sharded step and decode: (i) `steps` steps in f32 and in
    bf16 with remat on a `mesh_shape` mesh of gloo ranks sharing the card
    (`vol_shard_rank`), from the same seeded weights and volumes as the
    one-process steps on the card (`refs`, `volumetric_step_part`'s; taken
    here when None), held to them in the losses, the codebook and the first
    step's gradients within limits from a spread of one-process readings
    (VOL_SHARD_SPREAD); collectives and bytes a step,
    a rank's warm step time and peak memory; (ii) the planted fault (zero
    halos) above the decoder gradient's limit; (iii) `edit_volume
    --partition spatial` on two ranks against the unsharded CLI on the same
    checkpoint and labels; (iv) `--mesh 1,1` under a one-rank group bit for
    bit no group, at `one_rank_size`³ (full widths). Returns the ranks'
    launches (the main path's)."""
    import torch

    from medical_image_editing_tpu_torch.cli import edit_volume
    from medical_image_editing_tpu_torch.cli.train_volumetric import _synthetic_volumes
    from medical_image_editing_tpu_torch.ops.vq import VQModule
    from medical_image_editing_tpu_torch.train.volumetric import init_volumetric
    from medical_image_editing_tpu_torch.utils.checkpoint import save_state_dir

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir) / "volumetric_sharded"
    work.mkdir()
    vols = _synthetic_volumes(batch, size, seed)
    np.save(work / "vols.npy", vols)
    # (iii)'s inputs: the seeded weights as a checkpoint, painted id volumes
    enc, dec, vq, _, _ = init_volumetric(torch.Generator().manual_seed(seed), filters=filters,
                                         dict_size=dict_size, volume_shape=vols.shape,
                                         device="cpu")
    codebook = VQModule(*vq.embed.shape)
    codebook.set_state(vq)
    save_state_dir(str(work / "ckpt"), {"enc": enc.state_dict(), "dec": dec.state_dict(),
                                        "vq": codebook.state_dict()})
    del enc, dec
    labels = work / "labels"
    labels.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(2):
        ids = rng.integers(1, dict_size + 1, (size // 8,) * 3).repeat(8, 0).repeat(8, 1)
        ids = ids.repeat(8, 2).astype(np.int32)
        ids[:, : size // 4] = 0  # a background band
        np.save(labels / f"vol_{i}.npy", ids)
    fl = ",".join(str(f) for f in filters)
    edit_argv = ["--ckpt", str(work / "ckpt"), "--labels", str(labels), "--filters", fl,
                 "--dict-size", str(dict_size), "--batch", "2",
                 *([] if cuda else ["--device", "cpu"])]
    world = mesh_shape[0] * mesh_shape[1]
    # the ranks start (imports, CUDA, the group) while this process takes
    # the one-process steps on the card, plain (unless given) and perturbed
    # (the spread); they step once it writes `go`
    procs = vol_shard_start(work, (mesh_shape, steps, filters, dict_size, seed, device,
                                   edit_argv), world)
    try:
        kw = dict(filters=filters, dict_size=dict_size, seed=seed, device=device)
        with conv_precision("ieee"):
            if refs is None:
                refs = {mode: vol_shard_steps(None, vols, mode=mode, steps=steps, **kw)
                        for mode in VOL_SHARD_MODES}
            spread = {mode: [] for mode in VOL_SHARD_MODES}
            for s in VOL_SHARD_SPREAD:
                for mode in VOL_SHARD_MODES:
                    spread[mode].append(vol_shard_gaps(
                        vol_shard_steps(None, vols, mode=mode, steps=steps, nudge=s, **kw),
                        refs[mode]))
            tf32_off()
        (work / "go").touch()
        t0 = time.perf_counter()
    finally:
        ranks = join_ranks(work, procs, timeout)
    ranks_s = time.perf_counter() - t0
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    limits = {mode: {k: [max(VOL_SHARD_LIMIT_MIN, VOL_SHARD_LIMIT_FACTOR * max(r))
                         for r in zip(*(g[k] for g in spread[mode]))]
                     for k in VOL_SHARD_GAPS} for mode in VOL_SHARD_MODES}
    gaps = {mode: [vol_shard_gaps(r[mode], refs[mode]) for r in ranks]
            for mode in VOL_SHARD_MODES}
    fault = [vol_shard_gaps(r["halo_fault"], refs["f32"]) for r in ranks]
    fault_margin = {k: max(g[k][0] for g in fault) / limits["f32"][k][0]
                    for k in ("enc_grad", "dec_grad", "total")}
    within = {mode: all(v <= lim for g in gaps[mode] for k in VOL_SHARD_GAPS
                        for v, lim in zip(g[k], limits[mode][k])) for mode in VOL_SHARD_MODES}
    same = {mode: all(ranks[0][mode]["losses"] == r[mode]["losses"]
                      and all(torch.equal(ranks[0][mode]["grads"][p], r[mode]["grads"][p])
                              for p in ("enc", "dec"))
                      and all(torch.equal(a[k], b[k]) for a, b in zip(ranks[0][mode]["vq"],
                                                                        r[mode]["vq"])
                              for k in ("cluster_size", "embed"))
                      for r in ranks[1:]) for mode in VOL_SHARD_MODES}

    # (iii) the unsharded decode of the same checkpoint and labels
    edit_gap = {}
    with conv_precision("ieee"), contextlib.redirect_stdout(io.StringIO()):
        for name, extra in (("f32", []), ("uint8", ["--uint8"])):
            if edit_volume.main(edit_argv + extra + ["--out", str(work / f"alone_{name}")]):
                raise RuntimeError(f"edit_volume {name} failed")
            diffs = [np.abs(np.load(work / f"edit_{name}" / f).astype(np.float64)
                            - np.load(work / f"alone_{name}" / f).astype(np.float64))
                     for f in sorted(os.listdir(work / f"alone_{name}"))]
            edit_gap[name] = {"files": len(diffs), "max_abs": max(float(d.max()) for d in diffs)}
        tf32_off()
    one_rank = vol_shard_one_rank_part(device, work, size=min(size, one_rank_size),
                                       steps=one_rank_steps, filters=filters,
                                       dict_size=dict_size, seed=seed)
    r0 = ranks[0]
    rec = {"phase": "volumetric", "part": "sharded", "device": str(device), "size": size,
           "batch": batch, "filters": list(filters), "dict_size": dict_size, "steps": steps,
           "mesh": list(mesh_shape), "backend": r0["backend"],
           "coords": [r["coords"] for r in ranks], "block": r0["f32"]["block"],
           "ranks_s": ranks_s, "launches": launches,
           "ranks_bit_identical": same, "gaps_to_one_process": gaps, "limits": limits,
           "spread": spread, "within_limits": within,
           "halo_fault_gaps": fault, "halo_fault_margin": fault_margin,
           "edit_partition_spatial_gap": edit_gap, "edit_s": r0["edit_s"],
           "one_rank_group": one_rank,
           "losses": {mode: {"sharded": r0[mode]["losses"], "one_process": refs[mode]["losses"]}
                      for mode in VOL_SHARD_MODES},
           "rank": {mode: {"step_s": r0[mode]["step_s"],
                           "warm_step_s_median": float(np.median(r0[mode]["step_s"][1:]
                                                                 or r0[mode]["step_s"])),
                           "collectives_per_step": r0[mode]["collectives"][-1],
                           "peak_bytes": r0[mode]["peak_bytes"]} for mode in VOL_SHARD_MODES},
           "tolerance": "each step's gaps within VOL_SHARD_LIMIT_FACTOR x the largest of the "
                        "one-process steps' ulp-nudged readings (VOL_SHARD_SPREAD), at least "
                        "VOL_SHARD_LIMIT_MIN; the zero-halo fault's first-step decoder "
                        "gradient and total-loss gaps at least VOL_SHARD_FAULT_MARGIN x their "
                        "limits; the partitioned decode "
                        "within 1e-4 (uint8: one level); --mesh 1,1 bit for bit"}
    if cuda:
        rec["card"] = nvidia_smi()
    emit(rec)
    checks = {"within": all(within.values()), "ranks": all(same.values()),
              "fault": min(fault_margin["dec_grad"], fault_margin["total"])
              >= VOL_SHARD_FAULT_MARGIN,
              "edit_f32": edit_gap["f32"]["max_abs"] <= 1e-4 and edit_gap["f32"]["files"] == 2,
              "edit_uint8": edit_gap["uint8"]["max_abs"] <= 1,
              "one_rank": one_rank["same_step_lines"] and one_rank["same_state"]
              and one_rank["same_png"] and len(one_rank["step_lines"]) == one_rank_steps}
    if not all(checks.values()):
        raise RuntimeError(f"volumetric sharding: {checks}; gaps {gaps}, limits {limits}, "
                           f"fault margin {fault_margin}, edit {edit_gap}")
    return launches


# --------------------------------------------------------------------------
# int8 serving decode (conv_s8) and checkpoint crossing
# --------------------------------------------------------------------------


def s8_conv_bound(b, h, w, cin, cout, kh, kw, out_bytes, bias):
    """Least time (ms) of one conv_s8 call and what bounds it: the s8 codes
    (Cin channels) and weights read once, k_scale and bias read once, the
    output written once; 2·B·H·W·kh·kw·Cin·Cout operations at the dense
    int8 tensor-core rate (stride 1, output the input's size)."""
    nbytes = (b * h * w * cin + kh * kw * cin * cout + 4 * cout * (2 if bias else 1)
              + out_bytes * b * h * w * cout)
    ops = 2 * b * h * w * kh * kw * cin * cout
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def s8_weights_bound(cout, cin, kh, kw):
    """Least time (ms) of one weight fold: the f32 weight and the maxima
    read once, the s8 codes (Cin padded to 32), k_scale and x_scale written
    once; five f32 operations a weight element (two products, a max, a
    division, a rounding)."""
    cp = -(-cin // 32) * 32
    nbytes = 4 * cout * cin * kh * kw + kh * kw * cout * cp + 4 * (2 * cin + cout)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 5 * cout * cin * kh * kw / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def s8_pass_bound(b, c, h, w, in_bytes, out_bytes):
    """Least time (ms) of an activation pass: the input read once, the
    output (a (C,) vector, or the s8 codes) written once, one f32 operation
    an element (a max, or a division)."""
    nbytes = in_bytes * b * c * h * w + out_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, b * c * h * w / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@contextlib.contextmanager
def plain_int8_convs():
    """Every `Conv` under `quantize_convs("int8")` through the plain
    versions (`int8_conv_reference`), on any device, inside the block."""
    from medical_image_editing_tpu_torch.models import blocks
    from medical_image_editing_tpu_torch.ops.quantized_conv import int8_conv_reference

    prev = blocks.int8_conv
    blocks.int8_conv = int8_conv_reference
    try:
        yield
    finally:
        blocks.int8_conv = prev


def decoder_conv_calls(decoder, embed):
    """The (Cin, Cout, kernel, dilation, padding, H, W, bias) of every `Conv`
    call of one decode of `embed`, in call order (hooks on the meta device;
    an int8 decode calls the same convolutions)."""
    import torch

    from medical_image_editing_tpu_torch.models.blocks import Conv

    calls = []

    def hook(m, args):
        _, cin, h, w = args[0].shape
        calls.append((cin, m.out_channels, m.kernel_size[0], m.dilation[0], m.padding[0],
                      h, w, m.bias is not None))

    meta = copy.deepcopy(decoder).to("meta").eval()
    handles = [m.register_forward_pre_hook(hook) for m in meta.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        meta(embed.to("meta"))
    for h in handles:
        h.remove()
    return calls


S8_KERNELS = ("conv_s8", "conv_s8_absmax", "conv_s8_quantize", "conv_s8_weights")


def int8_kernel_part(device, calls, batch, seed, iters=50):
    """(a) Each kernel of the int8 convolution against its plain version,
    bit for bit, at every distinct convolution of the decode (seeded
    inputs at the decode's shapes): channel maxima, the weight fold (codes,
    k_scale, x_scale), s8 codes, raw int32 sums, the dequantized f32
    output. Each timed (`ms`, CUDA events around `iters` calls;
    `device_ms`, profiler) beside its bound, its plain version and its
    launches per decode; `conv_s8` with the instance that took the shape.
    A checkout without the weight kernel folds with its plain version and
    times the other three. Returns the records."""
    import torch

    from medical_image_editing_tpu_torch.ops import quantized_conv as qc

    cuda = torch.device(device).type == "cuda"
    fold_kernel = hasattr(qc, "conv_s8_weights")
    gen = torch.Generator(device=device).manual_seed(seed)
    per_decode = {}
    for c in calls:
        per_decode[c] = per_decode.get(c, 0) + 1
    records = []
    for (cin, cout, k, d, pad, h, w, bias), n_calls in per_decode.items():
        x = torch.randn(batch, cin, h, w, generator=gen, device=device)
        wt = torch.randn(cout, cin, k, k, generator=gen, device=device) / (k * k * cin) ** 0.5
        b = torch.randn(cout, generator=gen, device=device) if bias else None
        geo = dict(kernel_size=(k, k), dilation=(d, d), padding=(pad, pad))
        amax = qc.channel_absmax(x)
        weight_checks = {}
        if fold_kernel:
            wq, k_scale, scale = qc.conv_s8_weights(wt, amax)
            plain_fold = qc.conv_s8_weights_reference(wt, amax)
            weight_checks = {"weights": all(bool(torch.equal(a, p)) for a, p in
                                            zip((wq, k_scale, scale), plain_fold))}
            weights_err = max(float((a.float() - p.float()).abs().max()) for a, p in
                              zip((wq, k_scale, scale), plain_fold))
        else:
            scale = qc.symmetric_scale(amax)
            wq, k_scale = qc.weight_codes(wt, scale)
        xq = qc.quantize_s8(x, scale)
        acc = qc.conv_s8(xq, wq, None, None, out_dtype=torch.int32, **geo)
        out = qc.conv_s8(xq, wq, k_scale, b, **geo)
        acc_ref = qc.conv_s8_reference(xq, wq, None, None, out_dtype=torch.int32, **geo)
        checks = {
            "absmax": bool(torch.equal(amax, qc.channel_absmax_reference(x))),
            **weight_checks,
            "codes": bool(torch.equal(xq, qc.quantize_s8_reference(x, scale))),
            "int32_sums": bool(torch.equal(acc, acc_ref)),
            "output": bool(torch.equal(out, qc.conv_s8_reference(xq, wq, k_scale, b, **geo))),
        }
        rec = {"phase": "int8", "part": "kernel", "b": batch, "cin": cin, "cout": cout,
               "kernel": k, "dilation": d, "padding": pad, "h": h, "w": w, "bias": bias,
               "calls_per_decode": n_calls, "checks": checks,
               "max_abs_err": float((out - qc.conv_s8_reference(
                   xq, wq, k_scale, b, **geo)).abs().max()),
               "int32_abs_max": int(acc_ref.abs().max())}
        if fold_kernel:
            rec["weights_max_abs_err"] = weights_err
        if hasattr(qc, "conv_s8_instance"):
            rec["conv_s8_instance"] = list(qc.conv_s8_instance(cout, xq.shape[-1], k, k, d, w))
        if cuda:
            timed = {
                "conv_s8": (lambda: qc.conv_s8(xq, wq, k_scale, b, **geo),
                            lambda: qc.conv_s8_reference(xq, wq, k_scale, b, **geo),
                            s8_conv_bound(batch, h, w, cin, cout, k, k, 4, bias),
                            "conv_s8_kernel"),
                "conv_s8_absmax": (lambda: qc.channel_absmax(x),
                                   lambda: qc.channel_absmax_reference(x),
                                   s8_pass_bound(batch, cin, h, w, 4, 4 * cin),
                                   "channel_absmax_kernel"),
                "conv_s8_quantize": (lambda: qc.quantize_s8(x, scale),
                                     lambda: qc.quantize_s8_reference(x, scale),
                                     s8_pass_bound(batch, cin, h, w, 4, batch * h * w * cin),
                                     "quantize_s8_kernel"),
            }
            if fold_kernel:
                timed["conv_s8_weights"] = (lambda: qc.conv_s8_weights(wt, amax),
                                            lambda: qc.conv_s8_weights_reference(wt, amax),
                                            s8_weights_bound(cout, cin, k, k),
                                            "conv_s8_weights_kernel")
            for name, (fn, plain, (bound_ms, bound_by), sym) in timed.items():
                ms = cuda_ms(fn, iters=iters)
                rec[name] = {"ms": ms, "device_ms": device_ms(fn, sym),
                             "plain_ms": cuda_ms(plain, warmup=1, iters=3),
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "roofline_share": bound_ms / ms}
            rec["conv_s8"]["ops"] = 2 * batch * h * w * k * k * cin * cout
            rec["conv_s8_absmax"]["library_ms"] = cuda_ms(
                lambda: torch.linalg.vector_norm(x, float("inf"), dim=(0, 2, 3)), iters=iters)
            rec["whole_call_ms"] = cuda_ms(
                lambda: qc.int8_conv(x, wt, b, padding=pad, dilation=d), iters=iters)
        emit(rec)
        if not all(checks.values()):
            raise RuntimeError(f"conv_s8 disagrees with its plain version at "
                               f"{(batch, cin, cout, k, d, h, w)}: {checks}")
        records.append(rec)
    return records


def int8_yardsticks(device, batch, cin, cout, size, seed, iters=50):
    """Yardsticks at the decode's widest full-resolution convolution (3×3
    SAME): `torch._int_mm` over an im2col of the same s8 codes (with the
    im2col, and the product alone), cuDNN's bf16 `F.conv2d` and the packed
    bf16 kernel; the int32 product checked against conv_s8's sums."""
    import torch
    import torch.nn.functional as F

    from medical_image_editing_tpu_torch.ops import quantized_conv as qc
    from medical_image_editing_tpu_torch.ops.conv_pack import conv3x3_packed_nchw

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, cin, size, size, generator=gen, device=device)
    wt = torch.randn(cout, cin, 3, 3, generator=gen, device=device) / (9 * cin) ** 0.5
    scale = qc.symmetric_scale(qc.channel_absmax(x))
    xq = qc.quantize_s8(x, scale)
    wq, _ = qc.weight_codes(wt, scale)
    geo = dict(kernel_size=(3, 3), dilation=(1, 1), padding=(1, 1))

    def im2col():  # (B·H·W, 9·Cin) s8, taps outer, channels inner, as wq
        xp = F.pad(xq[..., :cin], (0, 0, 1, 1, 1, 1))
        cols = xp.unfold(1, 3, 1).unfold(2, 3, 1)  # (B, H, W, C, ky, kx)
        return cols.permute(0, 1, 2, 4, 5, 3).reshape(batch * size * size, 9 * cin)

    wmat = wq[..., :cin].permute(1, 0, 2).reshape(cout, 9 * cin).t()  # (9·Cin, Cout)
    a = im2col().contiguous()
    prod = torch._int_mm(a, wmat)
    acc = qc.conv_s8(xq, wq, None, None, out_dtype=torch.int32, **geo)
    same = bool(torch.equal(prod.reshape(batch, size, size, cout).permute(0, 3, 1, 2), acc))
    xb, wb = x.bfloat16(), wt.bfloat16()
    rec = {"phase": "int8", "part": "yardsticks", "b": batch, "cin": cin, "cout": cout,
           "h": size, "w": size, "int_mm_equals_conv_s8_sums": same,
           "conv_s8_int32_ms": cuda_ms(lambda: qc.conv_s8(
               xq, wq, None, None, out_dtype=torch.int32, **geo), iters=iters),
           "int_mm_with_im2col_ms": cuda_ms(lambda: torch._int_mm(im2col().contiguous(), wmat),
                                            iters=iters),
           "int_mm_ms": cuda_ms(lambda: torch._int_mm(a, wmat), iters=iters),
           "cudnn_bf16_ms": cuda_ms(lambda: F.conv2d(xb, wb, padding=1), iters=iters),
           "packed_bf16_ms": cuda_ms(lambda: conv3x3_packed_nchw(xb, wb), iters=iters),
           "card": nvidia_smi()}
    emit(rec)
    if not same:
        raise RuntimeError("torch._int_mm over the im2col disagrees with conv_s8's sums")
    return rec


def int8_phase(device, model, painted, workdir, *, seed=0, microbatch=8, big_batch=32,
               kernel_batch=8, iters=50):
    """The int8 serving decode at `model` widths on the painted maps (B, H,
    W) of the serve phase: (a) the kernels at the decode's convolutions and
    the yardsticks; (b) `make_batched_edit_fn(quantize="int8")` on the
    batch and on `big_batch` maps with `microbatch`, launches per chunk held
    to the decoder's `Conv` count, each decode bit for bit the same decode
    through the plain versions on the card; the error against f32 framed as
    the JAX package's contract (int8 ≤ 4× bf16), timed beside f32 and bf16
    packed with peak memory, the batch and the microbatched big batch, both
    int8 decodes profiled; (c) `edit_batch.main --dtype int8` over painted
    NIfTIs. Returns the launch counts of (b) and (c)."""
    import torch

    from medical_image_editing_tpu_torch.cli import edit_batch
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model
    from medical_image_editing_tpu_torch.models.blocks import Conv
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.utils import nifti

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    b, size = int(painted.shape[0]), int(painted.shape[-1])
    cfg = lung_config(model)
    _, decoder, vq_state = load_model(cfg, device=device, seed=seed)
    window = (cfg.window_width, cfg.window_center, cfg.window_scale)
    n_convs = sum(isinstance(m, Conv) for m in decoder.modules())
    calls = decoder_conv_calls(decoder, torch.zeros(1, int(model["enc_filters"][0]), size, size))
    if len(calls) != n_convs:
        raise RuntimeError(f"{len(calls)} Conv calls a decode, {n_convs} Conv modules")

    # -- (a) the kernels at the decode's shapes, and the yardsticks
    kernels = int8_kernel_part(device, calls, kernel_batch, seed, iters=iters)
    f0 = int(model["dec_filters"][0])  # the full-resolution 3×3 f0 → f0, as the bf16 rows
    yard = int8_yardsticks(device, kernel_batch, f0, f0, size, seed, iters) if cuda else None

    # -- (b) the decode: main path, counted
    edit8 = make_batched_edit_fn(decoder, is_lung=True, dataset_window=window,
                                 quantize="int8", device=device)
    edit8m = make_batched_edit_fn(decoder, is_lung=True, dataset_window=window,
                                  quantize="int8", microbatch=microbatch, device=device)
    reps = -(-big_batch // b)
    big = np.concatenate([painted] * reps)[:big_batch]
    _build.launches.clear()
    out8 = edit8(vq_state, painted)
    sync()
    one = dict(_build.launches)
    out8m = edit8m(vq_state, big)
    sync()
    launches = dict(_build.launches)
    chunks = big_batch // microbatch
    want = {k: n_convs * (1 + chunks) for k in S8_KERNELS} if cuda else {}
    if cuda and ({k: one.get(k, 0) for k in S8_KERNELS} != {k: n_convs for k in S8_KERNELS}
                 or {k: launches.get(k, 0) for k in S8_KERNELS} != want):
        raise RuntimeError(f"int8 decode launches {launches} (one batch {one}); "
                           f"{n_convs} Convs a chunk")
    with plain_int8_convs():
        plain8 = edit8(vq_state, painted)
        plain8m = edit8m(vq_state, big)
    same = {"batch": bool(torch.equal(out8, plain8)), "microbatch": bool(torch.equal(out8m,
                                                                                     plain8m))}

    # the error against f32, framed as JAX's contract, and the times: the
    # batch on every route, the big batch with `microbatch` beside f32 and
    # bf16 packed
    times, times_micro, outs, peaks = {}, {}, {}, {}

    def timed_runs(edit, maps):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            edit(vq_state, maps)
            sync()
            runs.append(time.perf_counter() - t0)
        return runs

    routes = (("f32", None, "xla", None), ("bf16_cudnn", "bfloat16", "xla", None),
              ("bf16_packed", "bfloat16", "packed", None), ("int8", None, "xla", "int8"))
    for name, dtype, impl, quantize in routes:
        c = lung_config(model)
        c.compute_dtype = dtype
        dec = decoder if dtype is None else load_model(c, device=device, seed=seed)[1]
        with conv_route(impl):
            edit = make_batched_edit_fn(dec, is_lung=True, dataset_window=window,
                                        quantize=quantize, device=device)
            outs[name] = edit(vq_state, painted).float().cpu().numpy()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            times[name] = timed_runs(edit, painted)
            peaks[name] = torch.cuda.max_memory_allocated() if cuda else None
            if name != "bf16_cudnn":
                editm = make_batched_edit_fn(dec, is_lung=True, dataset_window=window,
                                             quantize=quantize, microbatch=microbatch,
                                             device=device)
                editm(vq_state, big)
                times_micro[name] = timed_runs(editm, big)
    # the int8 decodes profiled; the profiler's own host work lengthens its
    # window, so the idle share is also taken against the unprofiled median
    profiled = {}
    if cuda:
        for key, fn, runs in (("batch", lambda: edit8(vq_state, painted), times["int8"]),
                              ("microbatch", lambda: edit8m(vq_state, big),
                               times_micro["int8"])):
            wall, prof = profile_window(fn)
            profiled[key] = kernel_breakdown(wall, prof)
            profiled[key]["s8_kernels_device_s"] = {
                sym: sum(device_us(e) for e in prof if sym in e.key) / 1e6
                for sym in ("conv_s8_kernel", "channel_absmax_kernel", "quantize_s8_kernel",
                            "conv_s8_weights_kernel")}
            profiled[key]["idle_share_of_unprofiled"] = (
                1.0 - profiled[key]["device_busy_s"] / float(np.median(runs)))
    e16 = np.abs(outs["bf16_cudnn"] - outs["f32"])
    e8 = np.abs(outs["int8"] - outs["f32"])
    contract = {
        "int8_mean": float(e8.mean()), "bf16_mean": float(e16.mean()),
        "int8_p99": float(np.percentile(e8, 99)), "bf16_p99": float(np.percentile(e16, 99)),
    }
    contract["mean_ratio"] = contract["int8_mean"] / max(contract["bf16_mean"], 1e-4)
    contract["p99_ratio"] = contract["int8_p99"] / max(contract["bf16_p99"], 1e-3)
    contract["holds_4x_bf16"] = contract["mean_ratio"] < 4.0 and contract["p99_ratio"] < 4.0
    rec = {"phase": "int8", "part": "decode", "size": size, "batch": b,
           "big_batch": big_batch, "microbatch": microbatch, "convs_per_decode": n_convs,
           "launches": launches, "launches_one_batch": one,
           "kernel_equals_plain_on_card": same, "vs_f32": decode_gap(outs["int8"], outs["f32"]),
           "bf16_vs_f32": decode_gap(outs["bf16_cudnn"], outs["f32"]),
           "jax_contract": contract, "decode_s": times, "microbatch_decode_s": times_micro,
           "max_memory_allocated_bytes": peaks, "profile": profiled,
           "card": nvidia_smi() if cuda else None}
    emit(rec)
    if not all(same.values()):
        raise RuntimeError(f"int8 decode through the kernels differs from the plain one: {same}")
    for name, out in outs.items():
        if not np.isfinite(out).all() or out.min() < -1.0 or out.max() > 1.0:
            raise RuntimeError(f"{name} decode not finite in [-1, 1]")

    # -- (c) the CLI, main path, counted
    workdir = Path(workdir)
    label_dir, out_dir = workdir / "int8_labels", workdir / "int8_edited"
    label_dir.mkdir(parents=True, exist_ok=True)
    for i, m in enumerate(painted):
        nifti.save(nifti.to_nifti_array(m), str(label_dir / f"label_{i:04d}.nii.gz"),
                   dtype=np.int32)
    argv = ["--label-dir", str(label_dir), "--out-dir", str(out_dir), "--dtype", "int8",
            "--batch-size", str(b)] + ([] if cuda else ["--device", "cpu"])
    prev = os.environ.pop("LUNG_CKPT", None)
    try:
        _build.launches.clear()
        with conv_precision("ieee"):
            t0 = time.perf_counter()
            if edit_batch.main(argv) != 0:
                raise RuntimeError(f"edit_batch {argv} failed")
            cli_s = time.perf_counter() - t0
            tf32_off()
        cli_launches = dict(_build.launches)
        lung = LungConfig()
        lung.resume_checkpoint = None
        _, dec0, vq0 = load_model(lung, device=device)
    finally:
        if prev is not None:
            os.environ["LUNG_CKPT"] = prev
    want_cli = make_batched_edit_fn(dec0, is_lung=True, dataset_window=window,
                                    quantize="int8", device=device)(vq0, painted).cpu().numpy()
    got = np.stack([nifti.load(str(out_dir / f"edited_{i:04d}.nii.gz")) for i in range(b)])
    n_cli = sum(isinstance(m, Conv) for m in dec0.modules())
    cli_ok = bool(np.array_equal(got, np.stack([nifti.to_nifti_array(r) for r in want_cli])))
    emit({"phase": "int8", "part": "cli", "files": b, "seconds": cli_s,
          "launches": cli_launches, "equals_make_batched_edit_fn": cli_ok})
    if not cli_ok:
        raise RuntimeError("edit_batch --dtype int8 wrote other slices than its decode")
    if cuda and {k: cli_launches.get(k, 0) for k in S8_KERNELS} != {k: n_cli for k in S8_KERNELS}:
        raise RuntimeError(f"edit_batch --dtype int8 launches {cli_launches}, {n_cli} Convs")
    for k, v in cli_launches.items():
        launches[k] = launches.get(k, 0) + v
    return launches, {"kernels": kernels, "yardsticks": yard, "decode": rec}


def int8_kernels_phase(device, model, *, size=512, batch=8, seed=0):
    """The int8 phase's (a) alone (`--only int8`): the kernels of
    `csrc/conv_s8.cu` at every distinct convolution of the `model`-width
    decoder at `size`², batch `batch`, bit for bit their plain versions
    and timed."""
    import torch

    from medical_image_editing_tpu_torch.cli.run_recon import load_model

    _, decoder, _ = load_model(lung_config(model), device="cpu", seed=seed)
    calls = decoder_conv_calls(decoder, torch.zeros(1, int(model["enc_filters"][0]), size, size))
    return int8_kernel_part(device, calls, batch, seed)


def ckpt_crossing_phase(device, workdir, *, size=256, patients=2, slices=8, seed=0,
                        overrides=None):
    """Fault C.4 and the checkpoint crossings on the card: `run_vqwnet`
    trains 2 steps of the lung first stage (its widths, f32), then
    `export_ckpt` writes the reference `.ckpt` and `import_ckpt` reads it
    back; `run_recon.load_model` with `LUNG_CKPT` at the imported directory
    and at the run's own directory decodes a painted batch bit for bit as
    the trained state's own modules decode it, and the imported models'
    tensors equal the run's. Returns the launches."""
    import torch

    from medical_image_editing_tpu_torch.cli import export_ckpt, import_ckpt
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.checkpoint import (
        load_state_file,
        resolve,
        restore_state,
    )
    from medical_image_editing_tpu_torch.utils.config import to_config

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir) / "crossing"
    rng = np.random.default_rng(seed)
    write_lung_tree(work / "data", rng, patients=patients, slices=slices, size=size)
    base = json.loads(MODEL_CONFIG.read_text())
    for section, values in (overrides or {}).items():
        node = base
        for key in section.split("."):
            node = node[key]
        node.update(values)
    base["dataset"]["root_dir_path"] = str(work / "data")
    base["model"]["vqmodel"]["compute_dtype"] = "float32"
    base["run"]["n_epochs"] = 1
    base["save"]["study_name"] = "crossing"
    cfg_path = work / "crossing.json"
    dev = [] if cuda else ["--device", "cpu"]
    _build.launches.clear()
    t0 = time.perf_counter()
    run = run_cli(work, base, "run", ["-m", "train", "--max-steps", "2"], cuda)
    cfg_path.write_text(json.dumps(base))
    ckpt_dir = run / "version_0" / "ckpt"
    ref = str(work / "crossing.ckpt")
    if export_ckpt.main(["-c", str(cfg_path), "--ckpt", str(ckpt_dir), "--out", ref] + dev):
        raise RuntimeError("export_ckpt failed")
    imported = work / "imported"
    if import_ckpt.main(["-c", str(cfg_path), "--ckpt", ref, "--out", str(imported)] + dev):
        raise RuntimeError("import_ckpt failed")
    seconds = time.perf_counter() - t0

    trained = Trainer(to_config(base), device=device).init_state(load_staged=False)
    restore_state(str(ckpt_dir), trained)
    run_sd, imp_sd = load_state_file(resolve(str(ckpt_dir))), load_state_file(
        resolve(str(imported)))
    tensors_equal = all(torch.equal(run_sd[p][k].cpu(), imp_sd[p][k].cpu())
                        for p in ("encoder", "decoder") for k in run_sd[p])
    counters = (imp_sd["step"], imp_sd["epoch"]) == (run_sd["step"], run_sd["epoch"])
    window = (4096.0, 0.0, 2.0)
    ids = paint(rng.integers(1, int(base["model"]["vqmodel"]["dict_size"]) + 1,
                             (2, size, size)), rng, int(base["model"]["vqmodel"]["dict_size"]))
    want = make_batched_edit_fn(trained.decoder, is_lung=True, dataset_window=window,
                                device=device)(trained.vq, ids)
    decodes = {}
    prev = os.environ.get("LUNG_CKPT")
    try:
        for name, path in (("imported", imported), ("run", ckpt_dir)):
            os.environ["LUNG_CKPT"] = str(path)
            lung = LungConfig()
            for key in ("enc_filters", "dec_filters"):
                setattr(lung, key, tuple(base["model"]["vqmodel"][key]))
            lung.dict_size = int(base["model"]["vqmodel"]["dict_size"])
            _, dec, vq = load_model(lung, device=device)
            got = make_batched_edit_fn(dec, is_lung=True, dataset_window=window,
                                       device=device)(vq, ids)
            decodes[name] = bool(torch.equal(got, want))
    finally:
        if prev is None:
            os.environ.pop("LUNG_CKPT", None)
        else:
            os.environ["LUNG_CKPT"] = prev
    launches = dict(_build.launches)
    rec = {"phase": "ckpt_crossing", "size": size, "steps": int(run_sd["step"]),
           "seconds": seconds, "ckpt_bytes": os.path.getsize(ref),
           "imported_tensors_equal_run": tensors_equal, "counters_kept": counters,
           "decode_equals_trained_state": decodes, "launches": launches,
           "card": nvidia_smi() if cuda else None}
    emit(rec)
    if not (tensors_equal and counters and all(decodes.values()) and len(decodes) == 2):
        raise RuntimeError(f"checkpoint crossing: {rec}")
    return launches


# Gaps of the ddp phase's ranks to one process on the same rows after the
# first step (`ddp_gaps`), by compute dtype; measured on an NVIDIA H100
# 80GB HBM3 at 700 W. bf16 (one reading, before the references replayed
# the ranks' VQ ids): Adam's first moments 0.357
# encoder and 0.399 decoder, codebook 9.6e-4, total 2.5e-3; rank 1's
# moments with the planted fault 0.72 and 0.71. bf16 gradients of 4 + 4
# rows and of 8 differ that much: the convolutions' rounding at either
# batch (cuDNN takes other algorithms) moves VQ ids at near-ties, and the
# cross loss's per-code means weigh a moved pixel of a rare code heavily.
# f32 (fault C.8): each reference replays the ranks' VQ ids in its first
# step (`ranks_vq_ids`), and each limit is 5× the largest gap of a spread,
# rounded up to two digits (`tools/ddp_gap_spread.py`, one run on an NVIDIA
# H100 80GB HBM3, 700.00 W): seeds 0, 1, 2, each reference as shipped and
# changed at the rounding level (the xla conv route, cuDNN off, one-ulp
# nudged features, the f32 kernel summing in cuDNN's order), both ranks, 30
# readings a key. Largest gaps: encoder 0.140 (ulp, seed 2), decoder 2.77e-3
# (shipped, seed 0), codebook 1.29e-7, total 3.35e-6. The planted fault is
# checked against the decoder's limit (`DDP_FAULT_KEYS`): 0.315-0.56, 22.5×
# the limit or more. Without the replay the decoder read up to 0.0176 (an
# id moved at a near tie by the xla route's rounding).
DDP_GAP_LIMIT = {
    "bfloat16": {"encoder_moments": 0.5, "decoder_moments": 0.5, "codebook": 2e-3,
                 "total": 5e-3},
    "float32": {"encoder_moments": 0.70, "decoder_moments": 0.014, "codebook": 6.5e-7,
                "total": 1.7e-5},
}


@contextlib.contextmanager
def torchrun_env(**values):
    """The torchrun variables (RANK, WORLD_SIZE, ...) set inside the block,
    the previous environment restored after."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_config(overrides=None):
    """The lung first-stage config with `overrides` ({"a.b": {key: value}})."""
    base = json.loads(MODEL_CONFIG.read_text())
    for section, values in (overrides or {}).items():
        node = base
        for key in section.split("."):
            node = node[key]
        node.update(values)
    return base


def state_digest(state):
    """SHA-256 of every tensor of a train state (modules, Adam states,
    generator) and its counters."""
    import torch

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())

    walk(state.state_dict())
    return h.hexdigest()


def adam_moments(state):
    """Adam's first moments (an average of the steps' gradients) by
    parameter name, on the host."""
    return {f"{side}.{k}": opt.state[p]["exp_avg"].detach().float().cpu().clone()
            for side, m, opt in (("encoder", state.encoder, state.enc_opt),
                                 ("decoder", state.decoder, state.dec_opt))
            for k, p in m.named_parameters()}


def ddp_rank_run(rank, world, base, *, size, rows, steps, seed, device, fault):
    """k-means and `steps` steps of the Trainer's data-parallel first stage
    on this rank's rows; with `fault`, rank 1's gradients skip the average
    (it takes part in the all-reduce and keeps its own gradients). The VQ
    ids of the first step are recorded (`vq_ids`, one tensor an
    assignment) for the serial reference to replay."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train import first_stage
    from medical_image_editing_tpu_torch.train.state import replicate_state
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config
    from medical_image_editing_tpu_torch.utils.witness import recorded_vq_ids

    cuda = torch.device(device).type == "cuda"
    trainer = Trainer(to_config(base), device=device, seed=seed)
    if trainer.axis_name != mesh.DATA_AXIS:
        raise RuntimeError("the trainer under the group is not data parallel")
    state = replicate_state(trainer.init_state(load_staged=False))
    images = make_slices(np.random.default_rng(seed), world * rows, size)
    image = mesh.shard_batch(images, rank, world)
    synced = first_stage.pmean_gradients

    def keep_local(opt):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for g in opt.param_groups for p in g["params"]]
        mesh.pmean(grads)  # takes part in the collective, drops the average

    if fault and rank == 1:
        first_stage.pmean_gradients = keep_local
    try:
        _build.launches.clear()
        mesh.collectives.clear()
        first_stage.init_codebook_step(state.encoder)(state, image)
        vq_init = [t.detach().cpu().clone() for t in state.vq]
        gens, digests, losses, step_s, per_step, moments, embeds = [], [], [], [], [], [], []
        for i in range(steps):
            gens.append(state.generator.get_state().clone())
            before = dict(mesh.collectives)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_vq_ids() if i == 0 else contextlib.nullcontext() as seen:
                state, metrics = trainer.train_step(state, image)
            if i == 0:
                vq_ids = seen
            if cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({k: v - before.get(k, 0) for k, v in mesh.collectives.items()})
            losses.append({k: float(v) for k, v in metrics.items()})
            digests.append(state_digest(state))
            if len(losses) in (1, steps):
                moments.append(adam_moments(state))
            embeds.append(state.vq.embed.detach().cpu().clone())
        launches = dict(_build.launches)
    finally:
        first_stage.pmean_gradients = synced
    return {"vq_init": vq_init, "gens": gens, "digests": digests, "losses": losses,
            "step_s": step_s, "vq_ids": vq_ids,
            "collectives": per_step, "launches": launches, "moments": moments,
            "embed": embeds}


def ddp_rank(rank, world, init_file, workdir, base, size, rows, steps, seed, device,
             dtypes, gan):
    """One rank of the ddp phase's part (a), in a process of its own: a gloo
    group (NCCL refuses two ranks on one card) through `init_file`; the
    first stage in bf16 and in f32, the healthy run, then the run with the
    planted fault; then each GAN trainer of `gan` ({kind: (config, rows,
    side, steps)}), healthy, then one step with its planted fault; the
    results saved to `workdir/ddp-RANK.pt`."""
    import torch
    import torch.distributed as dist

    from medical_image_editing_tpu_torch.utils.device import apply_conv_precision

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    else:  # two ranks' OpenMP pools on one host spin against each other
        torch.set_num_threads(1)
    apply_conv_precision()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out = {dtype: {fault: ddp_rank_run(rank, world, with_dtype(base, dtype), size=size,
                                           rows=rows, steps=steps, seed=seed, device=device,
                                           fault=fault)
                       for fault in (False, True)}
               for dtype in dtypes}
        out["gan"] = {kind: ddp_gan_rank_runs(rank, world, kind, cfg, size=side, rows=n,
                                              steps=k, seed=seed, device=device)
                      for kind, (cfg, n, side, k) in gan.items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(workdir) / f"ddp-{rank}.pt")


def ddp_start_ranks(work, base, *, size, rows, steps, seed, device, dtypes, gan_args,
                    world=2):
    """`ddp_rank` on `world` spawned processes in `work` (made here),
    started → the processes."""
    import torch

    work.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ddp_rank, args=(r, world, str(work / "init"), str(work), base,
                                                size, rows, steps, seed, device, list(dtypes),
                                                gan_args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def ddp_join_ranks(work, procs, timeout=600):
    """The ranks of `ddp_start_ranks` joined within `timeout` seconds, any
    still alive killed → each rank's record (rank order)."""
    import torch

    try:
        for p in procs:
            p.join(timeout)
    finally:
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * len(procs):
        raise RuntimeError(f"ddp ranks: hung {hung}, exit codes {codes}")
    return [torch.load(work / f"ddp-{r}.pt", weights_only=True) for r in range(len(procs))]


def ddp_run_ranks(work, base, *, size, rows, steps, seed, device, dtypes, gan_args, world=2,
                  timeout=600):
    """`ddp_start_ranks`, then `ddp_join_ranks` → each rank's record."""
    procs = ddp_start_ranks(work, base, size=size, rows=rows, steps=steps, seed=seed,
                            device=device, dtypes=dtypes, gan_args=gan_args, world=world)
    return ddp_join_ranks(work, procs, timeout)


def with_dtype(base, dtype):
    """The config dict `base` with the model's compute dtype `dtype`."""
    cfg = copy.deepcopy(base)
    cfg["model"]["vqmodel"]["compute_dtype"] = dtype
    return cfg


def cat_draws(parts):
    """The views' draws of several ranks' rows as one batch's (row order)."""
    import torch

    def cat(ds):
        if ds[0] is None:
            return None
        return {k: None if ds[0][k] is None else torch.cat([d[k] for d in ds])
                for k in ds[0]}

    return {part: [cat([p[part][i] for p in parts]) for i in range(len(parts[0][part]))]
            for part in parts[0]}


def ranks_vq_ids(runs):
    """The ranks' recorded VQ ids (`vq_ids` of each rank's record, in rank
    order) as one process's on all their rows: each assignment's ids
    concatenated in row order (a rank's rows are a contiguous block,
    `mesh.shard_batch`, and an assignment's rows are (batch, h, w) in that
    order)."""
    import torch

    return [torch.cat(calls) for calls in zip(*(run["vq_ids"] for run in runs))]


@contextlib.contextmanager
def averaged_statistics(world):
    """Inside the block the VQ assignment's counts and sums are divided by
    `world` (the ranks average theirs), and the embedding cross loss is the
    mean of each rank's rows' (each rank's a mean over the (row, code)
    pairs its rows hold, as in JAX's data-parallel step). The block gets
    two lists, (queue, moved): ids put in `queue` are replayed, one tensor
    an assignment (`utils/witness.py::assignment_of`), in place of the
    assignment's own, and each replayed assignment appends to `moved` how
    many of the given ids differ from those it would have chosen itself (a
    readout of the near ties that the replay holds)."""
    from medical_image_editing_tpu_torch.ops import vq_fused
    from medical_image_editing_tpu_torch.train import first_stage
    from medical_image_editing_tpu_torch.utils.witness import assignment_of

    queue, moved = [], []
    assign, loss = vq_fused.vq_assign_fused, first_stage.embedding_loss

    def averaged(embed, flat):
        ids, quant, counts, sums = assign(embed, flat)
        if queue:
            given = queue.pop(0)
            moved.append(int((given.to(ids.device) != ids).sum()))
            ids, quant, counts, sums = assignment_of(given, embed.float(), flat.float())
        return ids, quant, counts / world, sums / world

    def per_rank_loss(q1, oh1, q2, oh2, codebook, **kw):
        parts = [loss(*(t.chunk(world)[r] for t in (q1, oh1, q2, oh2)), codebook, **kw)
                 for r in range(world)]
        return tuple(sum(p[i] for p in parts) / world for i in range(3))

    vq_fused.vq_assign_fused = averaged
    first_stage.embedding_loss = per_rank_loss
    try:
        yield queue, moved
    finally:
        vq_fused.vq_assign_fused = assign
        first_stage.embedding_loss = loss


def ddp_reference(base, run, *, world, size, rows, steps, seed, device, vq_ids):
    """One process, no group, on all `world`·`rows` rows with the ranks'
    draws (replayed from the replicated generator's state before each step
    of `run`, a rank's record), the function the ranks compute together:
    the VQ statistics divided by the world size (the ranks average them)
    and the embedding cross loss the mean of each rank's rows' (each rank's
    is a mean over the (row, code) pairs its rows hold, as in JAX's
    data-parallel step). Every other term is a mean over equal rows a rank,
    the same either way. Its own k-means on all the rows gives the codebook
    gap `kmeans`; the steps then start from the ranks' codebook, so that
    the first step starts from the ranks' state: bf16 features of 4 rows
    and of 8 differ in rounding (cuDNN takes other algorithms), which the
    50 Lloyd iterations carry into the codebook. The first step replays the
    ranks' VQ ids (`vq_ids`, `ranks_vq_ids`): the 4 rows a rank and the 8
    here round apart, and a code at a near tie would otherwise move (fault
    C.8); the ids that the replay held are counted (`ids_moved`)."""
    import torch

    from medical_image_editing_tpu_torch.ops import augment
    from medical_image_editing_tpu_torch.ops.vq import VQState
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.train.state import per_rank_generator
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    trainer = Trainer(to_config(base), device=device, seed=seed)
    state = trainer.init_state(load_staged=False)
    images = make_slices(np.random.default_rng(seed), world * rows, size)

    def draws(gen_state):
        views = []
        for r in range(world):
            g = torch.Generator(device=device)
            g.set_state(gen_state)
            g = per_rank_generator(g, r)
            views.append([augment.sample_view_draws(g, trainer.aug_cfg, rows, size, size, 1)
                          for _ in range(2)])
        return tuple(cat_draws([v[i] for v in views]) for i in range(2))

    with averaged_statistics(world) as (replay, moved):
        init_codebook_step(state.encoder)(state, images)
        ranks_vq = run["vq_init"]
        kmeans = float((state.vq.embed.cpu() - ranks_vq[0]).norm() / ranks_vq[0].norm())
        state.encoder.vq.set_state(VQState(*(t.to(state.device) for t in ranks_vq)))
        losses, moments, embeds = [], [], []
        for i in range(steps):
            replay.extend(vq_ids if i == 0 else ())
            state, metrics = trainer.train_step(state, images, draws(run["gens"][i]))
            if replay:
                raise RuntimeError(f"{len(replay)} recorded VQ assignments not replayed")
            losses.append({k: float(v) for k, v in metrics.items()})
            if i in (0, steps - 1):
                moments.append(adam_moments(state))
            embeds.append(state.vq.embed.detach().cpu().clone())
    return {"moments": moments, "losses": losses, "embed": embeds, "kmeans": kmeans,
            "ids_moved": moved}


def ddp_gaps(run, ref):
    """A rank's gaps to the reference, each a list: Adam's first moments
    over the encoder's and over the decoder's parameters after the first
    and the last step (the relative
    Frobenius norm of the difference: the gradients, weighted by size; the
    updates themselves are ±lr wherever Adam's first steps see any
    gradient, a rounding residue included), the codebook after each step
    (relative) and the total loss of each step (relative). The first step
    starts from the same state on both sides; later steps start from states
    that one step of ±lr updates has set apart."""
    def rel(a, b, side):
        keys = [k for k in b if k.startswith(side)]
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
        return (num / sum(float((b[k] ** 2).sum()) for k in keys)) ** 0.5

    return {**{f"{side}_moments": [rel(a, b, side) for a, b in zip(run["moments"],
                                                                  ref["moments"])]
               for side in ("encoder", "decoder")},
            "codebook": [float((a - b).norm() / b.norm())
                         for a, b in zip(run["embed"], ref["embed"])],
            "total": [abs(a["total"] - b["total"]) / abs(b["total"])
                      for a, b in zip(run["losses"], ref["losses"])]}


def fault_margin(fault_gaps, limit, keys):
    """How far the planted fault lands above the limits it is checked
    against: for each of `keys`, the largest rank's gap over the limit."""
    return {k: max(g[k] for g in fault_gaps) / limit[k] for k in keys}


def ddp_nccl_part(device, workdir, base, *, size, seed, steps):
    """(b): `run_vqwnet -m train --max-steps steps` alone and under a
    one-rank group made by the CLI from a torchrun environment (NCCL on the
    card, gloo on the CPU), held bit for bit (both runs in one process, on
    the same side of the ranks' join: nothing here picks cuDNN's algorithms
    by timing them). Returns the record and the grouped run's launches."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    if torch.backends.cudnn.benchmark:
        raise RuntimeError("cudnn.benchmark is on: the runs held bit for bit would pick "
                           "their algorithms by timing them on a shared card")
    cuda = torch.device(device).type == "cuda"
    work = Path(workdir)
    batch = int(base["dataset"]["batch_size"])
    write_lung_tree(work / "data", np.random.default_rng(seed), patients=2, slices=batch,
                    size=size)
    cli = copy.deepcopy(base)
    cli["dataset"]["root_dir_path"] = str(work / "data")
    cli["run"]["n_epochs"] = 2
    env = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost",
               MASTER_PORT=free_port())
    runs, launches = {}, {}
    for name in ("alone", "group"):
        with contextlib.ExitStack() as stack:
            if name == "group":
                stack.enter_context(torchrun_env(**env))
            _build.launches.clear()
            mesh.collectives.clear()
            runs[name] = run_cli(work, cli, name, ["-m", "train", "--max-steps", str(steps)],
                                 cuda) / "version_0"
            launches[name] = dict(_build.launches)
            if name == "group":
                collectives = dict(mesh.collectives)
        if mesh.is_active():
            raise RuntimeError("run_vqwnet left its process group behind")
    final = sorted(os.listdir(runs["alone"] / "ckpt"))[-1]
    sds = [load_state_file(str(runs[n] / "ckpt" / final)) for n in ("alone", "group")]
    same_logs = ((runs["alone"] / "log.csv").read_text()
                 == (runs["group"] / "log.csv").read_text())
    same_state = all(torch.equal(sds[0][p][k], sds[1][p][k])
                     for p in ("encoder", "decoder") for k in sds[0][p])
    same_state = same_state and torch.equal(sds[0]["generator"], sds[1]["generator"])
    rec = {"final_ckpt": final,
           "cli_bit_identical": {"log_csv": same_logs, "state": same_state},
           "cli_collectives": collectives, "launches": launches}
    return rec, launches["group"]


def ddp_bare_steps(device, base, *, size, seed, timed_steps):
    """(b)'s readout: bare steps of the Trainer's step timed under a
    one-rank group (NCCL on the card, gloo on the CPU) and without one, at
    the config's batch, with the card to itself."""
    import torch

    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.train.state import replicate_state
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    batch = int(base["dataset"]["batch_size"])
    env = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost")
    images = make_slices(np.random.default_rng(seed + 1), batch, size)
    timed = {}
    for name in ("group", "alone"):
        with contextlib.ExitStack() as stack:
            if name == "group":
                stack.enter_context(torchrun_env(**{**env, "MASTER_PORT": free_port()}))
                mesh.initialize_distributed(device)
                stack.callback(mesh.destroy_distributed)
            trainer = Trainer(to_config(base), device=device, seed=seed)
            state = replicate_state(trainer.init_state(load_staged=False))
            init_codebook_step(state.encoder)(state, images)
            trainer.train_step(state, images)  # warm
            mesh.collectives.clear()
            step_s = []
            for _ in range(timed_steps):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(state, images)
                if cuda:
                    torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            timed[name] = {"step_s": step_s, "axis_name": trainer.axis_name,
                           "collectives_per_step": {k: v / timed_steps
                                                    for k, v in mesh.collectives.items()}}
            if name == "group":
                timed[name]["backend"] = dist.get_backend()
    return timed


# The data-parallel GAN trainers' gaps to the serial reference after the
# first step (relative Frobenius norm of Adam's first moments, the codebook,
# the total loss), f32 under `ieee`, two gloo ranks sharing the card, the
# ranks' VQ ids replayed in the reference. Each limit is 5× the largest gap
# of the spread that sets DDP_GAP_LIMIT["float32"] (fault C.8; the same run,
# the same five references), rounded up to two digits. Largest gaps: second
# stage decoder 3.15e-3 (xla, seed 0), discriminator 2.03e-4 (ulp, seed 0;
# as shipped 1.6e-5-4.5e-5), total 1.4e-7; joint step encoder 0.261 (ulp),
# decoder 2.75e-3, discriminator 1.6e-5, codebook 1.29e-7, total 8.0e-7;
# VQGAN decoder 2.84e-4 (cuDNN off, ulp), discriminator 9.1e-5, codebook
# 2.6e-11, total 1.6e-7. Rank 1's discriminator moments with the planted
# fault (`DDP_FAULT_KEYS`): second stage 0.060-0.231 (55× its limit or
# more), joint 0.048-0.079 (605×), VQGAN 0.148-0.241 (321×).
DDP_GAN_GAP_LIMIT = {
    "second_stage": {"decoder_moments": 0.016, "discriminator_moments": 1.1e-3,
                     "total": 6.9e-7},
    "joint": {"encoder_moments": 1.4, "decoder_moments": 0.014,
              "discriminator_moments": 8.0e-5, "codebook": 6.5e-7, "total": 4.1e-6},
    "vqgan": {"decoder_moments": 1.5e-3, "discriminator_moments": 4.6e-4, "codebook": 1.4e-10,
              "total": 7.8e-7},
}
# The limits each trainer's planted fault is checked against (`fault_margin`).
# The fault leaves gradients unaveraged, so it cannot reach the loss or the
# codebook, which the step computes before the average. The first stage's
# encoder is left out: its gradient at random init is ill-conditioned (the
# card's step tests read 6-13% between a float32 step and its float64
# witness on the same ids; the spread's encoder gaps reach 0.140 with the
# ids replayed), so its limit (0.70) does not part a healthy run from a
# faulty one (0.46-0.74).
DDP_FAULT_KEYS = {"first_stage": ("decoder_moments",),
                  "second_stage": ("discriminator_moments",),
                  "joint": ("discriminator_moments",),
                  "vqgan": ("discriminator_moments",)}
# rows a rank and side of each GAN trainer's run on two ranks: two VQGAN
# ranks of 4 rows at 512² do not fit one card beside two CUDA contexts
DDP_GAN = {"second_stage": {"rows": 4, "size": 256}, "joint": {"rows": 4, "size": 256},
           "vqgan": {"rows": 2, "size": 512}}
GAN_PARTS = {"second_stage": (("decoder", "dec_opt"), ("discriminator", "dis_opt")),
             "joint": (("encoder", "enc_opt"), ("decoder", "dec_opt"),
                       ("discriminator", "dis_opt")),
             "vqgan": (("decoder", "dec_opt"), ("discriminator", "dis_opt"))}
GAN_FLAGS = {"second_stage": [], "joint": ["-w"], "vqgan": ["-v"]}


def ddp_gan_config(kind, overrides=None):
    """The shipped config of the GAN trainer `kind` (second_stage, joint or
    vqgan) as a dict in f32, the staged first stage cleared, `overrides`
    ({"a.b": {...}}) merged in."""
    path = {"second_stage": SECOND_CONFIG, "joint": MW_CONFIG, "vqgan": VQGAN_CONFIG}[kind]
    cfg = second_config(overrides, path=path)
    cfg["model"]["vqmodel"]["compute_dtype"] = "float32"
    return cfg


def gan_trainer(kind, base, device, seed):
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    return Trainer(to_config(base), device=device, seed=seed,
                   use_multi_window=kind == "joint", use_vqgan=kind == "vqgan")


@contextlib.contextmanager
def unaveraged_discriminator(dis_opt):
    """Inside the block the discriminator's gradients skip the average (the
    planted fault): this rank takes part in the all-reduce and keeps its
    own."""
    import torch

    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train import multi_window, second_stage

    real = second_stage.pmean_gradients

    def planted(opt):
        if opt is not dis_opt:
            return real(opt)
        mesh.pmean([p.grad if p.grad is not None else torch.zeros_like(p)
                    for g in opt.param_groups for p in g["params"]])

    second_stage.pmean_gradients = multi_window.pmean_gradients = planted
    try:
        yield
    finally:
        second_stage.pmean_gradients = multi_window.pmean_gradients = real


def gan_collectives_expected(kind, state, n_metrics, n_inner):
    """The all-reduces a step of the GAN trainer `kind` issues and their
    bytes (f32), from the models: each synced BatchNorm of the decoder
    (with `axis_name`) once a decode forward and once backward, its (mean,
    mean of squares); the VQ counts and sums once a training encode; the
    encoder's and the decoder's (or the VQGAN's) gradients once each; the
    discriminator's once an inner iteration (the joint step: once, after
    the windows); its floating-point buffers once; the metrics once."""
    from medical_image_editing_tpu_torch.models.blocks import FlaxBatchNorm

    floats = n_metrics
    count = 1
    decodes = {"second_stage": 1, "joint": 2, "vqgan": 0}[kind]
    norms = [m for m in state.decoder.modules()
             if isinstance(m, FlaxBatchNorm) and m.axis_name is not None]
    count += decodes * 2 * len(norms)
    floats += decodes * 2 * sum(2 * m.num_features for m in norms)
    encodes = {"second_stage": 0, "joint": 2, "vqgan": 1}[kind]
    k, c = state.vq.embed.shape
    count += encodes
    floats += encodes * k * (1 + c)
    for m in (state.encoder, state.decoder):
        if m is not None and not (m is state.encoder and kind == "second_stage"):
            count += 1
            floats += sum(p.numel() for p in m.parameters())
    dis_params = sum(p.numel() for p in state.discriminator.parameters())
    iters = 1 if kind == "joint" else n_inner
    count += iters + 1
    floats += iters * dis_params + sum(b.numel() for b in state.discriminator.buffers()
                                       if b.is_floating_point())
    return {"all_reduce": count, "all_reduce_bytes": 4 * floats}


def on_host(x):
    """A copy of a nested state dict with every tensor on the host."""
    import torch

    if isinstance(x, dict):
        return {k: on_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(on_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return copy.deepcopy(x)


def ddp_gan_rank_runs(rank, world, kind, base, *, size, rows, steps, seed, device):
    """The GAN trainer `kind` on this rank's rows under the group: the
    healthy run (`steps` steps), then, from the same initial state, one
    step with the planted fault. {False: healthy record, True: faulty}."""
    import torch

    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train.state import replicate_state

    trainer = gan_trainer(kind, base, device, seed)
    if trainer.axis_name != mesh.DATA_AXIS:
        raise RuntimeError("the trainer under the group is not data parallel")
    state = replicate_state(trainer.init_state(load_staged=False))
    start = on_host(state.state_dict())  # off the card: not in the runs' peaks
    image = mesh.shard_batch(make_slices(np.random.default_rng(seed), world * rows, size),
                             rank, world)
    out = {}
    for fault in (False, True):
        if fault:
            state.load_state_dict(start)
        out[fault] = ddp_gan_rank_run(rank, kind, trainer, state, image,
                                      steps=1 if fault else steps, device=device, fault=fault)
    del trainer, state, start
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def ddp_gan_rank_run(rank, kind, trainer, state, image, *, steps, device, fault):
    """The gathered k-means (not the VQGAN's) and `steps` steps of the GAN
    trainer `kind` on this rank's rows `image`, the Trainer's own step
    under the group; with `fault`, rank 1's discriminator gradients skip
    the average. The first step's VQ ids are recorded (`vq_ids`)."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.utils.witness import first_moments, recorded_vq_ids

    cuda = torch.device(device).type == "cuda"
    parts = GAN_PARTS[kind]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    mesh.collectives.clear()
    rec = {"gens": [], "digests": [], "losses": [], "step_s": [], "collectives": [],
           "buffer_drift": []}
    planted = unaveraged_discriminator(state.dis_opt) if fault and rank == 1 else None
    with planted or contextlib.nullcontext():
        if state.encoder is not None:
            init_codebook_step(state.encoder)(state, image)
        rec["vq_init"] = [t.detach().cpu().clone() for t in state.vq]
        for i in range(steps):
            rec["gens"].append(state.generator.get_state().clone())
            before = dict(mesh.collectives)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_vq_ids() if i == 0 else contextlib.nullcontext() as seen:
                state, metrics = trainer.train_step(state, image)
            if i == 0:
                rec["vq_ids"] = seen
            if cuda:
                torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            rec["collectives"].append({k: v - before.get(k, 0)
                                       for k, v in mesh.collectives.items()})
            rec["losses"].append({k: float(v) for k, v in metrics.items()})
            rec["digests"].append(state_digest(state))
            rec["buffer_drift"].append(int(state.discriminator.buffer_drift))
            if i == 0:
                rec["moments"] = first_moments(state, parts)
                rec["embed"] = state.vq.embed.detach().cpu().clone()
    rec["launches"] = dict(_build.launches)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    rec["collectives_expected"] = gan_collectives_expected(
        kind, state, len(rec["losses"][0]), trainer.second_cfg.n_inner_loops)
    return rec


@contextlib.contextmanager
def per_rank_cutmix(masks):
    """Inside the block the discriminator losses take `masks` in turn, one
    (B, 1, H, W) a call, each row its rank's box (the N-rank step, where
    each rank draws its own): `cutmix_mask` returns 1 − the mask, which the
    losses invert back."""
    from medical_image_editing_tpu_torch.train import multi_window, second_stage

    queue = list(masks)
    real = second_stage.cutmix_mask

    def per_row(box, height, width, dtype=None):
        return 1.0 - queue.pop(0)

    second_stage.cutmix_mask = multi_window.cutmix_mask = per_row
    try:
        yield
    finally:
        second_stage.cutmix_mask = multi_window.cutmix_mask = real
    if queue:
        raise RuntimeError(f"{len(queue)} per-rank CutMix masks not taken")


def ddp_gan_reference(kind, base, run, *, world, size, rows, seed, device, vq_ids):
    """One process, no group, the first step of the N-rank function of the
    GAN trainer `kind` computed serially on all `world`·`rows` rows: each
    rank's draws (replayed from the replicated generator's state before the
    step of `run`, a rank's record), its rows' CutMix composites under its
    own box (`per_rank_cutmix`), the VQ statistics divided by the world
    size and the embedding cross loss the mean of each rank's (as
    `ddp_reference`, the ranks' VQ ids `vq_ids` replayed), from the ranks'
    codebook after their k-means. Every other term is a mean over equal
    rows a rank, and the synced BatchNorms normalise over all the rows: the
    same either way. No collective."""
    import torch

    from medical_image_editing_tpu_torch.ops import augment
    from medical_image_editing_tpu_torch.ops.cutmix import cutmix_mask
    from medical_image_editing_tpu_torch.ops.vq import VQState
    from medical_image_editing_tpu_torch.train.second_stage import sample_cutmix_draws
    from medical_image_editing_tpu_torch.train.state import per_rank_generator
    from medical_image_editing_tpu_torch.utils.witness import first_moments

    trainer = gan_trainer(kind, base, device, seed)
    state = trainer.init_state(load_staged=False)
    images = make_slices(np.random.default_rng(seed), world * rows, size)
    if state.encoder is not None:
        state.encoder.vq.set_state(VQState(*(t.to(state.device) for t in run["vq_init"])))
    views, cuts = [], []
    for r in range(world):
        g = torch.Generator(device=device)
        g.set_state(run["gens"][0])
        g = per_rank_generator(g, r)
        if kind == "joint":
            views.append([augment.sample_view_draws(g, trainer.aug_cfg, rows, size, size, 1)
                          for _ in range(2)])
        cuts.append(sample_cutmix_draws(g, 3 if kind == "joint"
                                        else trainer.second_cfg.n_inner_loops, size, size))
    masks = []
    for i in range(len(cuts[0])):
        per = []
        for box, invert in (c[i] for c in cuts):
            m = 1.0 - cutmix_mask(box, size, size).to(device)
            m = torch.where(invert.to(device), 1.0 - m, m)
            per.append(m[None, None].expand(rows, 1, size, size))
        masks.append(torch.cat(per))
    nominal = [(cuts[0][i][0], torch.tensor(False, device=device)) for i in range(len(masks))]
    draws = nominal
    if kind == "joint":
        draws = (*(cat_draws([v[i] for v in views]) for i in range(2)), nominal)
    with averaged_statistics(world) as (replay, moved), per_rank_cutmix(masks):
        replay.extend(vq_ids)
        state, metrics = trainer.train_step(state, images, draws)
    if replay:
        raise RuntimeError(f"{len(replay)} recorded VQ assignments not replayed")
    return {"moments": first_moments(state, GAN_PARTS[kind]),
            "embed": state.vq.embed.detach().cpu().clone(),
            "losses": {k: float(v) for k, v in metrics.items()}, "ids_moved": moved}


def ddp_gan_gaps(kind, run, ref):
    """A rank's gaps to the serial reference after the first step: Adam's
    first moment of each module (relative Frobenius norm), the codebook
    (relative; not the second stage's, which is frozen) and the total
    loss (relative)."""
    gaps = {f"{m}_moments": float((run["moments"][m] - ref["moments"][m]).norm()
                                  / ref["moments"][m].norm()) for m, _ in GAN_PARTS[kind]}
    if kind != "second_stage":
        gaps["codebook"] = float((run["embed"] - ref["embed"]).norm() / ref["embed"].norm())
    gaps["total"] = abs(run["losses"][0]["total"] - ref["losses"]["total"]) / abs(
        ref["losses"]["total"])
    return gaps


def ddp_gan_launches_expected(kind, base, size, steps, seed):
    """Each kernel's launches a rank makes in `ddp_gan_rank_run`, derived
    from the models (the convolutions routed to the packed kernel, counted
    on the meta device): the k-means encodes once; a second-stage step
    encodes once (forward only) and decodes once (forward and the input
    gradient); a joint step encodes and decodes two views, each forward
    and backward; the VQGAN routes no convolution. One VQ assignment an
    encode."""
    import torch

    probe = gan_trainer(kind, base, "cpu", seed).init_state(load_staged=False)
    if kind == "vqgan":
        return {"conv3x3_packed": 0, "vq_fused": steps}
    model = probe.encoder
    enc = routed_convs(model, torch.zeros(1, 1, size, size))
    dec = routed_convs(probe.decoder, torch.zeros(1, model.emb_dim, size, size))
    if kind == "second_stage":
        return {"conv3x3_packed": enc + steps * (enc + 2 * dec), "vq_fused": steps}
    return {"conv3x3_packed": enc + steps * 4 * (enc + dec), "vq_fused": 2 * steps}


def ddp_gan_compare(kind, ranks, base, *, world, size, rows, steps, seed, device, limit, want):
    """(a) for the GAN trainer `kind`: the ranks' records (healthy and with
    the planted fault) held together and to the serial reference, their
    launches to `want` (`ddp_gan_launches_expected`; {} on the CPU)."""
    import torch

    healthy = [r["gan"][kind][False] for r in ranks]
    faulty = [r["gan"][kind][True] for r in ranks]
    t0 = time.perf_counter()
    ref = ddp_gan_reference(kind, base, healthy[0], world=world, size=size, rows=rows,
                            seed=seed, device=device, vq_ids=ranks_vq_ids(healthy))
    ref_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    gaps = [ddp_gan_gaps(kind, run, ref) for run in healthy]
    fault_gaps = [ddp_gan_gaps(kind, run, ref) for run in faulty]
    margin = fault_margin(fault_gaps, limit, DDP_FAULT_KEYS[kind])
    return {
        "rows_per_rank": rows, "size": size, "steps": steps,
        "ranks_bit_identical_each_step": [a == b for a, b in zip(healthy[0]["digests"],
                                                                 healthy[1]["digests"])],
        "generator_replicated": all(torch.equal(a, b) for a, b in
                                    zip(healthy[0]["gens"], healthy[1]["gens"])),
        "buffer_drift_per_rank": [run["buffer_drift"] for run in healthy],
        "gap_to_serial": gaps, "ids_moved_by_replay": ref["ids_moved"], "gap_limit": limit,
        "planted_fault_gap": fault_gaps,
        "planted_fault_ranks_bit_identical": [a == b for a, b in
                                              zip(faulty[0]["digests"], faulty[1]["digests"])],
        "within_limits": all(g[k] <= limit[k] for g in gaps for k in limit),
        "fault_keys": DDP_FAULT_KEYS[kind], "fault_margin": margin,
        "fault_caught": min(margin.values()) > 1.0,
        "collectives_per_step": healthy[0]["collectives"],
        "collectives_expected": healthy[0]["collectives_expected"],
        "collectives_as_expected": all(c == run["collectives_expected"] for run in healthy
                                       for c in run["collectives"]),
        "launches_per_rank": [run["launches"] for run in healthy],
        "launches_expected_per_rank": want,
        "launches_as_expected": all({k: run["launches"].get(k, 0) for k in want} == want
                                    for run in healthy),
        "step_s_per_rank": [run["step_s"] for run in healthy],
        "peak_bytes_per_rank": [run["peak_bytes"] for run in healthy],
        "losses_first": healthy[0]["losses"][0], "reference_losses": ref["losses"],
        "reference_s": ref_s,
        "finite": all(np.isfinite(v) for run in healthy for m in run["losses"]
                      for v in m.values())}


def ddp_gan_nccl_part(device, workdir, bases, *, seed, steps):
    """(b) for the GAN trainers: `run_vqwnet -m train --max-steps steps`
    (`-w`, `-v`) under a one-rank group made by the CLI from a torchrun
    environment (NCCL on the card, gloo on the CPU), each over a seeded
    tree of 2 patients × rows slices. Returns the record, the grouped runs'
    launches and the configs the runs took ({kind: (config, rows, side)},
    for `ddp_gan_bare_steps`)."""
    import torch

    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.parallel import mesh

    cuda = torch.device(device).type == "cuda"
    work = Path(workdir)
    rng = np.random.default_rng(seed)
    rec, launches, clis = {}, {}, {}
    for kind, (base, rows, size) in bases.items():
        data = work / f"{kind}_data"
        if kind == "vqgan":
            write_crc_tree(data, rng, patients=2, slices=rows, size=size)
        else:
            write_lung_tree(data, rng, patients=2, slices=rows, size=size)
        cli = copy.deepcopy(base)
        cli["dataset"].update(root_dir_path=str(data), batch_size=rows, image_size=[size, size])
        cli["run"]["n_epochs"] = 2
        env = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost",
                   MASTER_PORT=free_port())
        with torchrun_env(**env):
            _build.launches.clear()
            mesh.collectives.clear()
            run = run_cli(work, cli, kind, ["-m", "train", "--max-steps", str(steps),
                                            *GAN_FLAGS[kind]], cuda) / "version_0"
            launches[kind] = dict(_build.launches)
            collectives = dict(mesh.collectives)
        if mesh.is_active():
            raise RuntimeError("run_vqwnet left its process group behind")
        with open(run / "log.csv") as f:
            logged = [float(r["total"]) for r in csv.DictReader(f)]
        clis[kind] = (cli, rows, size)
        if cuda:
            torch.cuda.empty_cache()
        rec[kind] = {"rows": rows, "size": size, "logged_total": logged,
                     "ckpts": sorted(os.listdir(run / "ckpt")), "cli_collectives": collectives,
                     "launches": launches[kind]}
    return rec, launches, clis


def ddp_gan_bare_steps(device, clis, *, seed, timed_steps):
    """(b)'s readout for the GAN trainers: the bare step of one Trainer
    built under a one-rank group (NCCL on the card, gloo on the CPU) from
    each config of `clis` ({kind: (config, rows, side)}), timed there and
    again with the group destroyed, with the card to itself → {kind:
    {"group": ..., "alone": ...}}."""
    import torch

    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train.first_stage import init_codebook_step
    from medical_image_editing_tpu_torch.train.state import replicate_state

    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    out = {}
    for kind, (cli, rows, size) in clis.items():
        env = dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost")
        images = make_slices(np.random.default_rng(seed + 1), rows, size)

        def timed_steps_s(trainer, state):
            trainer.train_step(state, images)  # warm
            step_s = []
            for _ in range(timed_steps):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(state, images)
                if cuda:
                    torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            return step_s

        # one trainer, built under the group: its steps timed there, then
        # with the group destroyed (its collectives are then no-ops)
        with torchrun_env(**{**env, "MASTER_PORT": free_port()}):
            mesh.initialize_distributed(device)
            try:
                trainer = gan_trainer(kind, cli, device, seed)
                state = replicate_state(trainer.init_state(load_staged=False))
                if state.encoder is not None:
                    init_codebook_step(state.encoder)(state, images)
                timed = {"group": {"step_s": timed_steps_s(trainer, state),
                                   "axis_name": trainer.axis_name,
                                   "backend": dist.get_backend()}}
            finally:
                mesh.destroy_distributed()
        timed["alone"] = {"step_s": timed_steps_s(trainer, state), "axis_name": None}
        del trainer, state
        if cuda:
            torch.cuda.empty_cache()
        out[kind] = timed
    return out


def ddp_phase(device, workdir, *, size=256, rows=4, steps=3, seed=0, overrides=None,
              timed_steps=3, limits=DDP_GAP_LIMIT, gan=DDP_GAN, gan_overrides=None,
              gan_steps=2, gan_limits=DDP_GAN_GAP_LIMIT, gan_timed_steps=1):
    """Data-parallel first-stage training (ROADMAP 15(i)) on the card.

    (a) Two ranks sharing the card (gloo on CUDA tensors: NCCL refuses two
    ranks on one device), each a process of its own: the Trainer at the
    lung config's full widths (bf16, the packed conv route, the VQ kernel),
    `rows` rows of `size`² each, the state replicated, the gathered k-means
    and `steps` steps, in the config's bf16 and again in f32; after each
    step the ranks' states are bit for bit equal (digests). Held to one
    process on all the rows with the same draws and the function the ranks
    compute together (`ddp_reference`, from the ranks' codebook after the
    k-means; its own k-means' gap is printed): after the first step within
    `limits` of the dtype (DDP_GAP_LIMIT, the card's; later steps' gaps are
    printed: one step of
    Adam's ±lr updates sets two trajectories apart); then a planted fault,
    rank 1's gradients skipping the average, must land above the limits of
    `DDP_FAULT_KEYS` (f32 is there because bf16's own gap leaves the fault
    only ~1.2× above it). The bf16 run's launches of both kernels, on each rank, are held to
    the counts derived from the model; collectives and bytes all-reduced a
    step, step times.
    (b) `ddp_nccl_part`: a one-rank group through `run_vqwnet` bit for bit
    the run without one; step time with and without the group
    (`ddp_bare_steps`).
    The `run_vqwnet` runs of (b) (`ddp_nccl_part`, `ddp_gan_nccl_part`)
    take the card in this process while the ranks run (their `step_s`
    readouts then read a card shared with them: `ranks_share_card_with`);
    the launches the ranks must count are derived on the CPU meanwhile;
    the serial references (they replay the ranks' VQ ids) and the timed
    bare steps of (b) come after the join, with the card to this process.
    `overlap` gives when each started and ended, seconds from the phase's
    start.
    The GAN trainers (ROADMAP 15(ii)), in f32 at their configs' full
    widths (`gan`: {kind: {rows, size}}; `gan_overrides` shrinks them for a
    CPU rehearsal): (a) on the same two ranks, the second stage, the joint
    step and the VQGAN, each the gathered k-means (not the VQGAN's) and
    `gan_steps` steps, the ranks bit for bit equal after each, the
    discriminator's buffer average changing no element; after the first
    step held to the serial reference (`ddp_gan_reference`) within
    `gan_limits`, and a planted fault (rank 1's discriminator gradients
    left unaveraged) above the discriminator's limit; collectives and
    bytes a step held to the count derived from the models, launches to
    the derived counts, each rank's peak memory; (b) `ddp_gan_nccl_part`: each through `run_vqwnet`
    under a one-rank NCCL group, 2 steps, and its bare step timed with and
    without the group (`ddp_gan_bare_steps`).
    Returns the launches of (a)'s bf16 first stage and its GAN runs on
    both ranks, and (b)'s grouped runs."""
    import torch

    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    cuda = torch.device(device).type == "cuda"
    base = ddp_config(overrides)
    gan_bases = {kind: (ddp_gan_config(kind, (gan_overrides or {}).get(kind)), g["rows"],
                        g["size"]) for kind, g in gan.items()}
    world = 2
    work = Path(workdir) / "ddp"
    t_phase = time.perf_counter()
    gan_args = {kind: (cfg, n, side, gan_steps) for kind, (cfg, n, side) in gan_bases.items()}
    if cuda:  # the card's memory for the ranks and this process's one-rank runs
        gc.collect()
        torch.cuda.empty_cache()
    procs = ddp_start_ranks(work, base, size=size, rows=rows, steps=steps, seed=seed,
                            device=device, dtypes=list(limits), gan_args=gan_args, world=world)
    overlap = {}
    threads = torch.get_num_threads()
    try:
        if not cuda:  # the ranks' one thread each, and this process's
            torch.set_num_threads(1)
        overlap["one_rank_started_s"] = time.perf_counter() - t_phase
        nccl, nccl_launches = ddp_nccl_part(device, work / "one_rank", base, size=size,
                                            seed=seed, steps=steps)
        gan_nccl, gan_nccl_launches, gan_clis = ddp_gan_nccl_part(
            device, work / "gan_one_rank", gan_bases, seed=seed, steps=2)
        overlap["one_rank_ended_s"] = time.perf_counter() - t_phase
        # the launches the ranks' runs must count, derived from the models on
        # the CPU while the ranks run
        model = to_config(base).model.vqmodel
        enc_convs = dec_convs = 0
        if cuda:
            probe = Trainer(to_config(base), device="cpu", seed=seed).init_state(
                load_staged=False)
            enc_convs = routed_convs(probe.encoder,
                                     torch.zeros(1, int(model.in_channels), size, size))
            dec_convs = routed_convs(probe.decoder,
                                     torch.zeros(1, probe.encoder.emb_dim, size, size))
            del probe
        want = {"conv3x3_packed": enc_convs + steps * 4 * (enc_convs + dec_convs),
                "vq_fused": 2 * steps} if cuda else {}
        gan_want = {kind: ddp_gan_launches_expected(kind, cfg, side, gan_steps, seed)
                    if cuda else {} for kind, (cfg, _, side) in gan_bases.items()}
        overlap["derived_s"] = time.perf_counter() - t_phase
    except BaseException:
        for p in procs:
            p.kill()
            p.join()
        raise
    finally:
        torch.set_num_threads(threads)
    ranks = ddp_join_ranks(work, procs)
    ranks_s = overlap["ranks_joined_s"] = time.perf_counter() - t_phase

    compare = {}
    for dtype, limit in limits.items():
        healthy = [r[dtype][False] for r in ranks]
        faulty = [r[dtype][True] for r in ranks]
        ref = ddp_reference(with_dtype(base, dtype), healthy[0], world=world, size=size,
                            rows=rows, steps=steps, seed=seed, device=device,
                            vq_ids=ranks_vq_ids(healthy))
        gaps = [ddp_gaps(run, ref) for run in healthy]
        fault_gaps = [ddp_gaps(run, ref) for run in faulty]
        margin = fault_margin([{k: v[0] for k, v in g.items()} for g in fault_gaps], limit,
                              DDP_FAULT_KEYS["first_stage"])
        compare[dtype] = {
            "ranks_bit_identical_each_step": [
                a == b for a, b in zip(healthy[0]["digests"], healthy[1]["digests"])],
            "generator_replicated": all(torch.equal(a, b) for a, b in
                                        zip(healthy[0]["gens"], healthy[1]["gens"])),
            "kmeans_codebook_gap": ref["kmeans"], "gap_to_one_process": gaps,
            "ids_moved_by_replay": ref["ids_moved"],
            "gap_limit": limit, "planted_fault_gap": fault_gaps,
            "planted_fault_ranks_bit_identical": [
                a == b for a, b in zip(faulty[0]["digests"], faulty[1]["digests"])],
            "within_limits": all(g[k][0] <= limit[k] for g in gaps for k in limit),
            "fault_keys": DDP_FAULT_KEYS["first_stage"], "fault_margin": margin,
            "fault_caught": min(margin.values()) > 1.0,
            "step_s_per_rank": [run["step_s"] for run in healthy],
            "losses_last": healthy[0]["losses"][-1],
            "reference_losses_last": ref["losses"][-1],
            "finite": all(np.isfinite(v) for run in healthy for m in run["losses"]
                          for v in m.values())}
    main = [r[str(base["model"]["vqmodel"]["compute_dtype"])][False] for r in ranks]

    launches = [run["launches"] for run in main]
    counted = all({k: n.get(k, 0) for k in want} == want for n in launches)

    t0 = time.perf_counter() - t_phase
    nccl["bare_step"] = ddp_bare_steps(device, base, size=size, seed=seed,
                                       timed_steps=timed_steps)
    overlap["bare_steps_s"] = [t0, time.perf_counter() - t_phase]
    rec = {"phase": "ddp", "part": "two_ranks_one_card", "backend": "gloo", "world": world,
           "rows_per_rank": rows, "size": size, "steps": steps,
           "compute_dtype": str(model.compute_dtype),
           "params": sum(t.numel() for t in main[0]["moments"][0].values()),
           "param_tensors": len(main[0]["moments"][0]), "by_dtype": compare,
           "collectives_per_step": main[0]["collectives"][-1],
           "launches_per_rank": launches, "launches_expected_per_rank": want,
           "ranks_share_card_with": "one_rank_parts", "overlap": overlap,
           "ranks_seconds": ranks_s, **nccl, "phase_seconds": time.perf_counter() - t_phase,
           "card": nvidia_smi() if cuda else None}
    emit(rec)
    checks = {"ranks_identical": all(all(c["ranks_bit_identical_each_step"])
                                     and c["generator_replicated"] for c in compare.values()),
              "within_limits": all(c["within_limits"] for c in compare.values()),
              "fault_caught": all(c["fault_caught"]
                                  and not all(c["planted_fault_ranks_bit_identical"])
                                  for c in compare.values()),
              "launches": counted and (not cuda or all(
                  nccl_launches.get(k, 0) > 0 for k in want)),
              "one_rank_group": all(nccl["cli_bit_identical"].values()),
              "finite": all(c["finite"] for c in compare.values())}
    if not all(checks.values()):
        raise RuntimeError(f"ddp phase: {checks}")
    t_gan = time.perf_counter()
    gan_compare = {kind: ddp_gan_compare(kind, ranks, cfg, world=world, size=side, rows=n,
                                         steps=gan_steps, seed=seed, device=device,
                                         limit=gan_limits[kind], want=gan_want[kind])
                   for kind, (cfg, n, side) in gan_bases.items()}
    for kind, c in gan_compare.items():
        emit({"phase": "ddp", "part": "gan_two_ranks_one_card", "trainer": kind,
              "backend": "gloo", "world": world, "ranks_share_card_with": "one_rank_parts",
              **c})
    t0 = time.perf_counter() - t_phase
    for kind, timed in ddp_gan_bare_steps(device, gan_clis, seed=seed,
                                          timed_steps=gan_timed_steps).items():
        gan_nccl[kind]["bare_step"] = timed
    overlap["gan_bare_steps_s"] = [t0, time.perf_counter() - t_phase]
    emit({"phase": "ddp", "part": "gan_one_rank_group", "trainers": gan_nccl,
          "overlap": overlap, "gan_seconds": time.perf_counter() - t_gan,
          "phase_seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi() if cuda else None})
    want_kernels = ("conv3x3_packed", "vq_fused") if cuda else ()
    gan_checks = {
        "gan_ranks_identical": all(all(c["ranks_bit_identical_each_step"])
                                   and c["generator_replicated"]
                                   for c in gan_compare.values()),
        "gan_buffer_average_exact": all(d == 0 for c in gan_compare.values()
                                        for run in c["buffer_drift_per_rank"] for d in run),
        "gan_within_limits": all(c["within_limits"] for c in gan_compare.values()),
        "gan_fault_caught": all(c["fault_caught"]
                                and not all(c["planted_fault_ranks_bit_identical"])
                                for c in gan_compare.values()),
        "gan_collectives": all(c["collectives_as_expected"] for c in gan_compare.values()),
        "gan_launches": all(c["launches_as_expected"] for c in gan_compare.values()),
        "gan_one_rank_group": all(
            len(r["logged_total"]) == 2 and all(np.isfinite(r["logged_total"]))
            and r["ckpts"] and r["cli_collectives"].get("all_reduce", 0) > 0
            and r["bare_step"]["group"]["axis_name"] == "data"
            and all(r["launches"].get(k, 0) > 0 for k in want_kernels
                    if k != "conv3x3_packed" or kind != "vqgan")
            for kind, r in gan_nccl.items()),
        "gan_finite": all(c["finite"] for c in gan_compare.values())}
    if not all(gan_checks.values()):
        raise RuntimeError(f"ddp phase, GAN trainers: {gan_checks}")
    total = {}
    gan_launches = [run["launches"] for r in ranks for kind in gan_bases
                    for fault, run in r["gan"][kind].items() if not fault]
    for n in (*launches, nccl_launches, *gan_launches, *gan_nccl_launches.values()):
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    return total


# the export phase's variants: (name, compute dtype, conv route)
EXPORT_VARIANTS = (("f32_xla", None, "xla"), ("bf16_packed", "bfloat16", "packed"))
EXPORT_BATCHES = (1, 8)

# The export phase's fresh process: torch and the artifact's loader (which
# registers the conv kernel's operator), no model module. argv: the work
# directory (painted.npy, edit_<name>.pt2), the variants, the batches, the
# timed decodes, the device, the torch threads (the caller's: on the CPU the
# thread count picks oneDNN's blocking, and with it the order of sums).
# Writes artifact_<name>_<batch>.npy and prints one line: each variant's
# load time, launches (of the checked decodes and of all), decode times at
# the last batch; the package modules imported.
ARTIFACT_SERVER = """
import json, sys, time
import numpy as np
import torch
from medical_image_editing_tpu_torch.cli.export_model import load_edit_artifact
from medical_image_editing_tpu_torch.ops import _build
from medical_image_editing_tpu_torch.utils.device import apply_conv_precision

apply_conv_precision()
work, names, batches, timed, device, threads = sys.argv[1:7]
torch.set_num_threads(int(threads))
batches, cuda = [int(b) for b in batches.split(",")], device != "cpu"
painted = np.load(work + "/painted.npy")
runs = {}
for name in names.split(","):
    t0 = time.perf_counter()
    call = load_edit_artifact(f"{work}/edit_{name}.pt2", device=device)
    load_s = time.perf_counter() - t0
    _build.launches.clear()
    for b in batches:
        np.save(f"{work}/artifact_{name}_{b}.npy", call(painted[:b]).cpu().numpy())
    checked = dict(_build.launches)
    decode_s = []
    for _ in range(int(timed)):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(painted[:batches[-1]])
        if cuda:
            torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
    runs[name] = {"load_s": load_s, "launches_checked": checked,
                  "launches": dict(_build.launches), "decode_s": decode_s, "meta": call.meta}
mods = sorted(m for m in sys.modules if m.startswith("medical_image_editing_tpu"))
print("artifact-server:" + json.dumps({"runs": runs, "modules": mods}))
"""


def export_phase(device, model, painted, workdir, *, timed=3, seed=0):
    """The edit decode exported and served from a fresh process (see the
    module docstring, 8i). Returns the launches counted in that process (the
    export path's)."""
    import torch

    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.export_model import (
        export_edit_artifact,
        save_edit_artifact,
    )
    from medical_image_editing_tpu_torch.cli.run_recon import load_model
    from medical_image_editing_tpu_torch.ops import _build
    from medical_image_editing_tpu_torch.ops.conv_pack import LAUNCH_KEYS

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    work = Path(workdir)
    size, batches = painted.shape[-1], [b for b in EXPORT_BATCHES if b <= len(painted)]
    np.save(work / "painted.npy", painted[:batches[-1]])
    recs = {}
    for name, dtype, impl in EXPORT_VARIANTS:
        cfg = lung_config(model)
        cfg.compute_dtype = dtype
        _, dec, vq = load_model(cfg, device=device, seed=seed)
        window = (cfg.window_width, cfg.window_center, cfg.window_scale)
        with conv_route(impl):
            n_dec = routed_convs(dec, torch.zeros(1, vq.embed.shape[1], size, size))
            edit = make_batched_edit_fn(dec, is_lung=True, dataset_window=window, device=device)
            _build.launches.clear()
            eager = {b: edit(vq, painted[:b]).cpu().numpy() for b in batches}
            sync()
            eager_launches = dict(_build.launches)
            eager_s = []
            for _ in range(timed):
                sync()
                t0 = time.perf_counter()
                edit(vq, painted[:batches[-1]])
                sync()
                eager_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            artifact = export_edit_artifact(dec, vq, image_size=size, is_lung=True,
                                            dataset_window=window, device=device)
            export_s = time.perf_counter() - t0
        nodes = sum(1 for n in artifact.program.graph.nodes if n.op == "call_function"
                    and str(n.target).startswith("medimg.conv3x3_packed"))
        nbytes = save_edit_artifact(str(work / f"edit_{name}.pt2"), artifact)
        recs[name] = {"route": impl, "compute_dtype": dtype or "float32",
                      "routed_convs_per_decode": n_dec if impl == "packed" else 0,
                      "op_nodes": nodes, "artifact_bytes": nbytes, "export_s": export_s,
                      "eager_launches": eager_launches, "eager_decode_s": eager_s,
                      "eager": eager}
        del dec, artifact, edit
        if cuda:
            torch.cuda.empty_cache()

    # -- main path: the artifacts served by a process without the models
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", ARTIFACT_SERVER, str(work),
                        ",".join(recs), ",".join(map(str, batches)), str(timed), device,
                        str(torch.get_num_threads())],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"export: the artifact server failed:\n{r.stderr[-3000:]}")
    served = json.loads(next(line for line in r.stdout.splitlines()
                             if line.startswith("artifact-server:"))[len("artifact-server:"):])
    server_s = time.perf_counter() - t0
    imported_models = [m for m in served["modules"]
                       if m.startswith("medical_image_editing_tpu_torch.models")
                       or m.split(".")[0] == "medical_image_editing_tpu"]
    launches, failures = {}, []
    for name, rec in recs.items():
        run = served["runs"][name]
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        gaps = {}
        for b in batches:
            got = np.load(work / f"artifact_{name}_{b}.npy")
            want = rec["eager"][b]
            gaps[b] = {"bit_equal": bool(got.dtype == want.dtype and got.shape == want.shape
                                         and np.array_equal(got, want)),
                       "max_abs_err": float(np.abs(got - want).max()),
                       "finite_in_range": bool(np.isfinite(got).all() and got.min() >= -1
                                               and got.max() <= 1)}
        # the packed route's launches are the bf16 instance's; the xla
        # route launches no instance
        key = LAUNCH_KEYS["bf16"] if rec["route"] == "packed" else "conv3x3_packed"
        rec.update(artifact_launches_checked=run["launches_checked"],
                   artifact_launches=run["launches"], artifact_load_s=run["load_s"],
                   artifact_decode_s=run["decode_s"], vs_eager=gaps, meta=run["meta"])
        derived = len(batches) * rec["routed_convs_per_decode"] if cuda else 0
        if not all(g["bit_equal"] and g["finite_in_range"] for g in gaps.values()):
            failures.append(f"{name}: the artifact's decode is not the eager one's: {gaps}")
        if rec["op_nodes"] != rec["routed_convs_per_decode"]:
            failures.append(f"{name}: {rec['op_nodes']} operator nodes, "
                            f"{rec['routed_convs_per_decode']} routed convolutions")
        if (run["launches_checked"].get(key, 0), rec["eager_launches"].get(key, 0)) != (
                derived, derived):
            failures.append(f"{name}: {key} launches: artifact {run['launches_checked']}, "
                            f"eager {rec['eager_launches']}, derived {derived}")
        del rec["eager"]
    out = {"phase": "export", "size": size, "batches": batches, "variants": recs,
           "server_s": server_s, "server_imported_models": imported_models,
           "server_modules": served["modules"],
           "card": nvidia_smi() if cuda else None}
    emit(out)
    if imported_models:
        failures.append(f"the artifact server imported {imported_models}")
    if failures:
        raise RuntimeError("export phase: " + "; ".join(failures))
    return launches


DOCTOR_CHECKS = ("versions", "env", "backend", "nvcc", "kernels", "native", "mesh")


def start_doctor():
    """`python -m medical_image_editing_tpu_torch.cli.doctor` started in the
    background (it runs beside the ddp phase, whose checks time nothing;
    the doctor's ~35 s are mostly process start-ups on the host, and the
    ddp ranks' first step times are readouts) → (the process, its start
    time), for `doctor_phase`."""
    return subprocess.Popen([sys.executable, "-m", "medical_image_editing_tpu_torch.cli.doctor"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), time.perf_counter()


def doctor_phase(started, timeout=900):
    """The doctor started by `start_doctor`: exit 0, and every check `ok`.
    Killed if it runs past `timeout` seconds from its start."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = [line for line in out.splitlines() if line.startswith("[")]
    checks = {line[7:17].strip(): line[1:5].strip() for line in lines}
    emit({"phase": "doctor", "exit_code": proc.returncode, "checks": checks, "lines": lines,
          "seconds": time.perf_counter() - t0})
    if proc.returncode != 0 or tuple(checks) != DOCTOR_CHECKS or set(checks.values()) != {"ok"}:
        raise RuntimeError(f"doctor: exit {proc.returncode}, checks {checks}\n{err[-2000:]}")


S8_SOURCE = "medical_image_editing_tpu_torch/csrc/conv_s8.cu"
S8_REPLACES = {
    "conv_s8": "medical_image_editing_tpu/ops/quantized_conv.py:104 (XLA's s8 convolution, "
               "lax.conv_general_dilated with preferred_element_type=int32; no Pallas kernel)",
    "conv_s8_absmax": "medical_image_editing_tpu/ops/quantized_conv.py:58 (XLA's amax in "
                      "_quantize_sym; no Pallas kernel)",
    "conv_s8_quantize": "medical_image_editing_tpu/ops/quantized_conv.py:60 (XLA's divide, "
                        "round, clip and convert in _quantize_sym; no Pallas kernel)",
    "conv_s8_weights": "medical_image_editing_tpu/ops/quantized_conv.py:86-87 with :56-61 "
                       "(XLA's fold of the activation scales into the kernel and its "
                       "_quantize_sym; no Pallas kernel)",
}


def s8_kernel_lines(int8, int8_launches, others, partitioned):
    """The `kernels` line's entries of the four int8 kernels: the numbers
    of the full-resolution 3×3 convolution (the yardsticks' shape), every
    shape of the decode as points, launches on the int8 path and the
    partitioned decode's int8 runs (`partitioned`, by path), 0 elsewhere."""
    yard = int8["yardsticks"]
    main = next(r for r in int8["kernels"] if (r["cin"], r["cout"], r["kernel"], r["dilation"],
                                               r["h"]) == (yard["cin"], yard["cout"], 3, 1,
                                                           yard["h"]))
    lines = []
    for name in S8_KERNELS:
        rec = main[name]
        line = {"name": name, "route": "cuda", "source": S8_SOURCE,
                "replaces": S8_REPLACES[name],
                "launches": int8_launches.get(name, 0) + sum(n.get(name, 0)
                                                             for n in partitioned.values()),
                "launches_by_path": {"int8": int8_launches.get(name, 0),
                                     **{p: n.get(name, 0) for p, n in partitioned.items()},
                                     **{p: n.get(name, 0) for p, n in others.items()}},
                "max_abs_err": (main["weights_max_abs_err"] if name == "conv_s8_weights"
                                else main["max_abs_err"]),
                "shape": {k: main[k] for k in ("b", "cin", "cout", "kernel", "dilation", "h",
                                               "w")},
                **{k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": rec.get("library_ms"),
                "points": [{k: r[k] for k in ("cin", "cout", "kernel", "dilation", "h",
                                              "calls_per_decode")}
                           | {k: r[name][k] for k in ("ms", "device_ms", "plain_ms",
                                                       "bound_ms", "bound_by")}
                           for r in int8["kernels"]]}
        if name == "conv_s8":
            line["library_note"] = ("no PyTorch call computes an int8 convolution on CUDA "
                                    "(F.conv2d refuses int8); yardsticks at the shape:")
            line["yardsticks"] = {k: yard[k] for k in (
                "int_mm_with_im2col_ms", "int_mm_ms", "cudnn_bf16_ms", "packed_bf16_ms",
                "conv_s8_int32_ms")}
        elif name == "conv_s8_absmax":
            line["library_note"] = "torch.linalg.vector_norm(x, inf, dim=(0, 2, 3))"
        elif name == "conv_s8_weights":
            line["library_note"] = ("none: no single PyTorch call folds and quantizes the "
                                    "weight; its yardstick is its plain version on the card "
                                    "(`weight_codes`, plain_ms)")
        else:
            line["library_note"] = ("none: no PyTorch call writes per-channel s8 codes "
                                    "channels-innermost")
        lines.append(line)
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("vq", "conv", "int8"),
                        help="build one kernel's source and run only the device phase and "
                             "that kernel's phase, with no result line: for holding two "
                             "checkouts' versions of the kernel to each other in one call")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    timing, t_start = {}, time.perf_counter()

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            timing[name] = time.perf_counter() - t0

    with timed("device"):
        info = device_phase()
    model = json.loads(MODEL_CONFIG.read_text())["model"]["vqmodel"]
    if args.only:
        build_phase([{"vq": "vq_fused", "conv": "conv3x3_packed", "int8": "conv_s8"}[args.only]])
        if args.only == "vq":
            kernel_phase("cuda", seed=args.seed)
        elif args.only == "conv":
            conv_hash_phase("cuda", seed=args.seed)
        else:
            int8_kernels_phase("cuda", model, seed=args.seed)
        return 0
    from medical_image_editing_tpu_torch.ops.conv_pack import LAUNCH_KEYS

    with timed("build"):
        build_phase()
    with timed("kernel"):
        vq_points = kernel_phase("cuda", seed=args.seed)
    vq = vq_points[0]
    with timed("conv"):
        conv = conv_kernel_phase("cuda", seed=args.seed)
    with timed("serve"), tempfile.TemporaryDirectory() as tmp:
        serve_launches, served = serve_phase("cuda", model, tmp, seed=args.seed)
        profile_phase(served)
    painted = served.painted
    del served
    with timed("serve_runtime"), tempfile.TemporaryDirectory() as tmp:
        runtime_launches = serve_runtime_phase("cuda", model, painted, tmp, seed=args.seed)
    with timed("edit_partition"), tempfile.TemporaryDirectory() as tmp:
        partition_launches, serve_partition_launches = edit_partition_part(
            "cuda", model, painted, tmp, seed=args.seed)
    with timed("int8"), tempfile.TemporaryDirectory() as tmp:
        int8_launches, int8 = int8_phase("cuda", model, painted, tmp, seed=args.seed)
    with timed("export"), tempfile.TemporaryDirectory() as tmp:
        export_launches = export_phase("cuda", model, painted, tmp, seed=args.seed)
    cfg = load_config()
    pending = []  # card-vs-CPU parts whose CPU side runs in the background
    doctor = None  # the doctor's process, started before the ddp phase
    try:
        with conv_route("packed"):
            with timed("train"):
                train_launches, trained = train_phase("cuda", cfg, seed=args.seed)
                train_profile_phase(trained)
                bare_step_s = trained.warm_s
                del trained
                train_reference_phase(cfg, seed=args.seed + 1)
            with timed("f32_step"):
                f32_launches = f32_step_phase("cuda", cfg, seed=args.seed)
            with tempfile.TemporaryDirectory() as tmp:
                with timed("trainer"):
                    trainer_launches = trainer_phase("cuda", tmp, seed=args.seed,
                                                     bare_step_s=bare_step_s)
                with timed("prior"):
                    prior_launches = prior_phase("cuda", tmp, trainer_checkpoint(tmp),
                                                 seed=args.seed, defer=pending)
                with timed("second_stage"):
                    second_launches = second_stage_phase("cuda", tmp, seed=args.seed,
                                                         defer=pending)
                with timed("multi_window"):
                    mw_launches = multi_window_phase("cuda", tmp, seed=args.seed,
                                                     defer=pending)
                with timed("vqgan"):
                    vqgan_launches = vqgan_phase("cuda", tmp, seed=args.seed, defer=pending)
                with timed("losses"):
                    losses_launches = losses_phase("cuda", tmp, seed=args.seed)
                with timed("volumetric"):
                    vol_launches = volumetric_phase("cuda", tmp, seed=args.seed)
                doctor = start_doctor()
                with timed("ddp"):
                    ddp_launches = ddp_phase("cuda", tmp, seed=args.seed)
        with timed("ckpt_crossing"), tempfile.TemporaryDirectory() as tmp:
            crossing_launches = ckpt_crossing_phase("cuda", tmp, seed=args.seed)
        with timed("reference_join"):
            while pending:
                finish_reference(pending.pop(0))
        with timed("doctor_join"):
            doctor_phase(doctor)
    finally:
        for handle in pending:  # a phase failed: stop the CPU sides still running
            handle.proc.kill()
            handle.proc.join()
            shutil.rmtree(handle.tmp, ignore_errors=True)
        if doctor is not None and doctor[0].poll() is None:
            doctor[0].kill()
            doctor[0].communicate()
    # (d) no other path launches an int8 kernel
    others = {"serve": serve_launches, "serve_bf16_packed": runtime_launches,
              "serve_partition": serve_partition_launches, "export": export_launches,
              "train": train_launches, "f32_step": f32_launches["ieee_packed"],
              "f32_step_tf32": f32_launches["tf32_packed"], "trainer": trainer_launches,
              "prior": prior_launches,
              "second_stage": second_launches, "multi_window": mw_launches,
              "vqgan": vqgan_launches, "losses": losses_launches, "volumetric": vol_launches,
              "ddp": ddp_launches, "ckpt_crossing": crossing_launches}
    stray = {path: {k: n.get(k, 0) for k in S8_KERNELS if n.get(k, 0)}
             for path, n in others.items() if any(n.get(k, 0) for k in S8_KERNELS)}
    emit({"phase": "int8", "part": "other_paths", "s8_launches": stray})
    if stray:
        raise RuntimeError(f"int8 kernels launched off the int8 path: {stray}")

    main_conv = {inst: next(r for r in conv if r["instance"] == inst and "forward" in r
                            and (r["cin"], r["cout"], r["h"]) == CONV_POINTS[0])
                 for inst in ("bf16", "f32", "tf32")}
    # each conv instance's launches on the main paths that launched it, from
    # each path's own counts (zeroed just before it, read just after)
    paths = {**others, "int8": int8_launches, "edit_partition": partition_launches}
    instance_paths = {inst: {name: n[key] for name, n in paths.items() if n.get(key)}
                      for inst, key in LAUNCH_KEYS.items()}
    missing = [inst for inst, by_path in instance_paths.items() if not by_path]
    if missing:
        raise RuntimeError(f"no main path launched the conv kernel's {missing} instances")
    emit({"kernels": [{
        "name": "vq_fused", "route": "cuda", "source": VQ_SOURCE,
        "replaces": VQ_REPLACES,
        "launches": (serve_launches.get("vq_fused", 0) + train_launches.get("vq_fused", 0)
                     + trainer_launches.get("vq_fused", 0) + prior_launches.get("vq_fused", 0)
                     + second_launches.get("vq_fused", 0) + mw_launches.get("vq_fused", 0)
                     + vqgan_launches.get("vq_fused", 0) + losses_launches.get("vq_fused", 0)
                     + vol_launches.get("vq_fused", 0) + crossing_launches.get("vq_fused", 0)
                     + ddp_launches.get("vq_fused", 0)),
        "launches_by_path": {"serve": serve_launches.get("vq_fused", 0),
                             "train": train_launches.get("vq_fused", 0),
                             "trainer": trainer_launches.get("vq_fused", 0),
                             "prior": prior_launches.get("vq_fused", 0),
                             "second_stage": second_launches.get("vq_fused", 0),
                             "multi_window": mw_launches.get("vq_fused", 0),
                             "vqgan": vqgan_launches.get("vq_fused", 0),
                             "losses": losses_launches.get("vq_fused", 0),
                             "volumetric": vol_launches.get("vq_fused", 0),
                             "int8": int8_launches.get("vq_fused", 0),
                             "serve_partition": serve_partition_launches.get("vq_fused", 0),
                             "ckpt_crossing": crossing_launches.get("vq_fused", 0),
                             "ddp": ddp_launches.get("vq_fused", 0)},
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
        "launches": sum(instance_paths["bf16"].values()),
        "launches_by_path": instance_paths["bf16"],
        "instance": "bf16",
        "max_abs_err": main_conv["bf16"]["forward_max_abs_err"],
        "shape": {"b": main_conv["bf16"]["b"], "cin": main_conv["bf16"]["cin"],
                  "cout": main_conv["bf16"]["cout"], "h": main_conv["bf16"]["h"],
                  "w": main_conv["bf16"]["w"], "dtype": "bfloat16", "direction": "forward"},
        **{k: main_conv["bf16"]["forward"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")},
        "library_note": "F.conv2d (cuDNN) at the same shape and dtype",
        "points": [{"instance": r["instance"], "path": r["path"], "dir": d, "b": r["b"],
                    "cin": r[d]["cin"], "cout": r[d]["cout"], "h": r["h"],
                    **{k: r[d][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "vs_library", "device_ms", "library_device_ms")}}
                   for r in conv if "forward" in r and r["instance"] == "bf16"
                   for d in ("forward", "dx")],
    }, *[{
        "name": f"conv3x3_packed_{inst}", "route": "cuda", "source": CONV_SOURCE,
        "replaces": CONV_REPLACES, "instance": inst, "kernel": CONV_PATHS[inst][0],
        "precision": main_conv[inst]["precision"],
        "launches": sum(instance_paths[inst].values()),
        "launches_by_path": instance_paths[inst],
        "max_abs_err": main_conv[inst]["forward_max_abs_err"],
        "shape": {k: main_conv[inst][k] for k in ("b", "cin", "cout", "h", "w")}
        | {"dtype": "float32", "direction": "forward"},
        **{k: main_conv[inst]["forward"][k] for k in ("ms", "device_ms", "plain_ms",
                                                      "bound_ms", "bound_by", "library_ms")},
        "library_note": (f"F.conv2d (cuDNN) at the same shape, f32 under "
                         f"{main_conv[inst]['precision']}"),
        "points": [{"dir": d, "b": r["b"], "cin": r[d]["cin"], "cout": r[d]["cout"],
                    "h": r["h"],
                    **{k: r[d].get(k) for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                                "library_ieee_ms", "library_tf32_ms",
                                                "bound_ms", "vs_library",
                                                "vs_library_device", "library_device_ms",
                                                "kernel")}}
                   for r in conv if "forward" in r and r["instance"] == inst
                   for d in ("forward", "dx")],
    } for inst in ("f32", "tf32")], *s8_kernel_lines(int8, int8_launches, others,
                                                      {"edit_partition": partition_launches})]})
    timing["total"] = time.perf_counter() - t_start
    emit({"phase": "timing", "seconds": timing})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
