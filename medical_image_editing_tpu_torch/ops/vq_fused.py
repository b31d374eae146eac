"""Fused VQ: assign + lookup + EMA statistics in one pass.

Counterpart of `medical_image_editing_tpu/ops/vq_pallas.py`. On a CUDA
tensor `vq_assign_fused` launches the hand-written kernel
`csrc/vq_fused.cu` (it replaces the Pallas TPU kernel `_vq_kernel`; the
source note says what bounds it and how the design answers); a build or
launch failure raises. On a CPU tensor it computes the same function with
`vq_assign_fused_reference`, the plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel to.

The kernel takes fewer than `MAX_ROWS` rows, so that its per-launch counts
stay exact in f32; `vq_assign_fused` walks larger inputs in row chunks below
that limit and adds the chunks' counts and sums in chunk order, a fixed
order, so reruns stay bit-identical. The JAX kernel has no such limit.

`vq_apply_fused` is the drop-in for `ops.vq.vq_apply` (same returns).
"""

import contextlib
import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .vq import VQState, quantize, vq_scores

KERNEL = "vq_fused"
# rows of one launch: its counts are exact in f32 only below 2**24
MAX_ROWS = 2**24
# dynamic shared memory one Hopper block may use
MAX_SMEM_BYTES = 232448

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        lib.vq_fused_instance.argtypes = [ctypes.c_int] * 2
        lib.vq_fused_instance.restype = ctypes.c_int
        lib.vq_fused_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.vq_fused_smem_bytes.restype = ctypes.c_longlong
        lib.vq_fused_grid.argtypes = [ctypes.c_int] * 3
        lib.vq_fused_grid.restype = ctypes.c_int
        lib.vq_fused_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 6
        )
        lib.vq_fused_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_path(c: int, k: int) -> str:
    """The instance of the kernel template that takes a (K, C) codebook:
    "c16k10" (C and K compiled in) or "generic" (read from the arguments)."""
    return "c16k10" if _kernel_lib().vq_fused_instance(c, k) else "generic"


def vq_assign_fused_reference(
    embed: torch.Tensor, flat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: flat (N,C) × embed (K,C) →
    (ids (N,) int32, quantized (N,C), counts (K,), sums (K,C)), all f32."""
    embed = embed.float()
    flat = flat.float()
    k = embed.shape[0]
    ids = vq_scores(embed, flat).argmax(1)
    onehot = (ids[:, None] == torch.arange(k, device=flat.device)[None, :]).float()
    return ids.to(torch.int32), embed[ids], onehot.sum(0), onehot.t() @ flat


@functools.lru_cache(maxsize=64)
def _grid(n: int, c: int, k: int, device_index: int) -> int:
    """Blocks of the persistent grid for (N, C, K) on the current device."""
    lib = _kernel_lib()
    smem = lib.vq_fused_smem_bytes(c, k)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"codebook K={k}, C={c} needs {smem} B of shared memory "
            f"(> {MAX_SMEM_BYTES} B a block may use)"
        )
    grid = lib.vq_fused_grid(n, c, k)
    if grid < 1:
        raise _build.KernelError(f"vq_fused: no grid for N={n}, C={c}, K={k} on cuda:{device_index}")
    return grid


def _launch(embed: torch.Tensor, flat: torch.Tensor):
    if embed.device != flat.device:
        raise ValueError(f"embed on {embed.device}, features on {flat.device}")
    if flat.dtype != torch.float32 or embed.dtype != torch.float32:
        raise TypeError(f"vq_fused takes float32, got {flat.dtype}/{embed.dtype}")
    if flat.dim() != 2 or embed.dim() != 2 or flat.shape[1] != embed.shape[1]:
        raise ValueError(f"shapes flat {tuple(flat.shape)}, embed {tuple(embed.shape)}")
    if not (flat.is_contiguous() and embed.is_contiguous()):
        raise ValueError("vq_fused takes contiguous tensors")
    n, c = flat.shape
    k = embed.shape[0]
    if not 0 < n < MAX_ROWS:
        raise ValueError(f"N={n}: the kernel takes 0 < N < 2**24 (exact f32 counts)")
    if k < 1 or c < 1:
        raise ValueError(f"empty codebook {tuple(embed.shape)}")
    if flat.data_ptr() % 16:
        flat = flat.clone()  # the kernel stages rows with 16-byte copies
    dev = flat.device
    lib = _kernel_lib()
    guard = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        grid = _grid(n, c, k, dev.index)
        ids = torch.empty(n, dtype=torch.int32, device=dev)
        quant = torch.empty(n, c, dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
        sums = torch.empty(k, c, dtype=torch.float32, device=dev)
        partials = torch.empty(grid * (k + k * c), dtype=torch.float32, device=dev)
        # the raw handle: torch.cuda.current_stream() builds a Stream object
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = lib.vq_fused_launch(
            flat.data_ptr(), embed.data_ptr(), n, c, k, grid, ids.data_ptr(),
            quant.data_ptr(), counts.data_ptr(), sums.data_ptr(), partials.data_ptr(),
            stream,
        )
    if err != 0:
        raise _build.KernelError(f"vq_fused launch failed: cudaError {err}")
    _build.launches[KERNEL] += 1
    return ids, quant, counts, sums


def vq_assign_fused(
    embed: torch.Tensor, flat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assign: flat (N,C) × embed (K,C) → (ids (N,) int32,
    quantized (N,C) f32, counts (K,) f32, sums (K,C) f32).

    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version. N ≥ `MAX_ROWS` rows go in chunks below it."""
    if flat.device.type == "cpu" and embed.device.type == "cpu":
        assign = vq_assign_fused_reference
    elif flat.device.type != "cuda":
        raise ValueError(f"vq_assign_fused: no kernel for device {flat.device}")
    else:
        assign = _launch
        embed, flat = embed.float().contiguous(), flat.float().contiguous()
    n = flat.shape[0]
    if n < MAX_ROWS:
        return assign(embed, flat)
    # a multiple of 4 rows keeps every chunk's start 16-byte aligned
    step = max(4, (MAX_ROWS - 1) // 4 * 4)
    parts = [assign(embed, flat[i : i + step]) for i in range(0, n, step)]
    counts, sums = parts[0][2], parts[0][3]
    for part in parts[1:]:
        counts = counts + part[2]
        sums = sums + part[3]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            counts, sums)


def vq_apply_fused(
    state: VQState,
    x: torch.Tensor,
    *,
    momentum: float = 0.99,
    eps: float = 1e-5,
    train: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Drop-in fused replacement for `ops.vq.vq_apply` (same contract)."""
    return quantize(state, x, vq_assign_fused, momentum=momentum, eps=eps,
                    train=train)
