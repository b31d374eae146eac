"""Fused VQ: assign + lookup + EMA statistics in one pass.

Counterpart of `medical_image_editing_tpu/ops/vq_pallas.py`. On a CUDA
tensor `vq_assign_fused` launches the hand-written kernel
`csrc/vq_fused.cu` (it replaces the Pallas TPU kernel `_vq_kernel`; the
source note says what bounds it and how the design answers); a build or
launch failure raises. On a CPU tensor it computes the same function with
`vq_assign_fused_reference`, the plain PyTorch version, which the tests and
`chip_smoke.py` hold the kernel to.

`vq_apply_fused` is the drop-in for `ops.vq.vq_apply` (same returns).
"""

import ctypes
from typing import Tuple

import torch

from . import _build
from .vq import VQState, quantize, vq_scores

KERNEL = "vq_fused"
# counts are exact in f32 only below 2**24
MAX_ROWS = 2**24
# dynamic shared memory one Hopper block may use
MAX_SMEM_BYTES = 232448

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        lib.vq_fused_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.vq_fused_smem_bytes.restype = ctypes.c_longlong
        lib.vq_fused_partials.argtypes = [ctypes.c_int] * 4
        lib.vq_fused_partials.restype = ctypes.c_longlong
        lib.vq_fused_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 6
        )
        lib.vq_fused_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _rows_per_block(n: int) -> int:
    # 256 threads a block, 1-4 rows a thread: fewer, fuller blocks (and fewer
    # partials to reduce) when N leaves at least two waves on 132 SMs
    return 256 * max(1, min(4, n // (256 * 2 * 132)))


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
    lib = _kernel_lib()
    rows = _rows_per_block(n)
    smem = lib.vq_fused_smem_bytes(k, c, rows)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"codebook K={k}, C={c} needs {smem} B of shared memory "
            f"(> {MAX_SMEM_BYTES} B a block may use)"
        )
    dev = flat.device
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    quant = torch.empty(n, c, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    sums = torch.empty(k, c, dtype=torch.float32, device=dev)
    partials = torch.empty(lib.vq_fused_partials(n, k, c, rows),
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vq_fused_launch(
            flat.data_ptr(), embed.data_ptr(), n, c, k, rows,
            ids.data_ptr(), quant.data_ptr(), counts.data_ptr(),
            sums.data_ptr(), partials.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"vq_fused launch failed: cudaError {err}")
    _build.launches[KERNEL] += 1
    return ids, quant, counts, sums


def vq_assign_fused(
    embed: torch.Tensor, flat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assign: flat (N,C) × embed (K,C) → (ids (N,) int32,
    quantized (N,C) f32, counts (K,) f32, sums (K,C) f32).

    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version."""
    if flat.device.type == "cpu" and embed.device.type == "cpu":
        return vq_assign_fused_reference(embed, flat)
    if flat.device.type != "cuda":
        raise ValueError(f"vq_assign_fused: no kernel for device {flat.device}")
    return _launch(embed.float().contiguous(), flat.float().contiguous())


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
