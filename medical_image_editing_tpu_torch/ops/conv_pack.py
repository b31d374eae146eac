"""3×3 SAME stride-1 convolution through a hand-written CUDA kernel.

Counterpart of `medical_image_editing_tpu/ops/conv_pack.py`. On CUDA
tensors the convolution launches `csrc/conv3x3_packed.cu`, which replaces
the Pallas TPU kernel `_kernel` (the source note says what bounds it and
how the design answers); a build or launch failure raises. On CPU tensors
it computes the same function with the plain PyTorch version
(`conv3x3_packed_reference`, `conv3x3_packed_reference_nchw`), which the
tests and `chip_smoke.py` hold the kernel to (meta tensors take it too, for
shapes without data).
The function is an f32-accumulated convolution without bias whose output
is in the input's dtype; the TPU kernel's four-pixel lane packing is a
layout trick of the TPU and is not part of it.

The source holds three kernels behind one launch, one for each instance
(`instance`): bf16 runs on the tensor cores (an implicit GEMM of
`mma.sync.m16n8k16`, bf16 products summed in f32); f32 follows
`torch.backends.cudnn.allow_tf32`, the flag that cuDNN's own f32
convolutions follow and that `utils/device.py::apply_conv_precision` sets
from `MEDIMG_CONV_PRECISION`: off ("ieee"), true f32 FMAs on the CUDA cores;
on ("tf32"), x and w rounded to TF32 and multiplied on the tensor cores
(`mma.sync.m16n8k8`), summed in f32. Each rounds the f32 sum once to the
output dtype. The TF32 instance's plain version is
`conv3x3_tf32_reference_nchw`. CPU and meta tensors ignore the flag: the
CPU's convolutions have no TF32, so they take the f32 plain version under
either setting.

Two layouts reach the same kernel, which reads activations through their
strides: the JAX package's public one (`conv3x3_packed`, NHWC activations,
HWIO weights), and the modules' NCHW/OIHW (`conv3x3_packed_nchw`), which
pays no transpose.

The gradient (`conv3x3_packed_trainable`, `conv3x3_packed_trainable_nchw`)
runs dx through the same kernel, on dy with the kernel flipped 180° and its
channels transposed, and computes dw directly from x and dy
(`torch.nn.grad.conv2d_weight`) without re-running the forward, as the JAX
package's `_c3p_bwd` does through `jax.vjp`. dw stays a library call, as
it is an XLA convolution outside the TPU kernel.

`packed_eligible` is the JAX package's static gate, unchanged: the modules
route exactly the convolutions JAX routes. Unlike the TPU kernel, this one
takes every Cin and Cout, so the backward's transposed shapes (Cin 64 →
Cout 32 for a 32 → 64 convolution, or a 32 → 16 one) never fall to a slow
path; a shape or dtype it cannot take raises.
"""

import contextlib
import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "conv3x3_packed"
# the kernels' grids: (column tiles × channel tiles, H / tile rows, B); the
# f32 tiles are 4 rows at least
_MAX_GRID_YZ = 65535
_MIN_TILE_ROWS = 4
# the C entry's modes, by instance: f32 on the CUDA cores (ieee), bf16 on the
# tensor cores, f32 rounded to TF32 on the tensor cores
MODES = {"f32": 0, "bf16": 1, "tf32": 2}
# the `_build.launches` key of each instance's launches; `KERNEL` counts them all
LAUNCH_KEYS = {inst: f"{KERNEL}:{inst}" for inst in MODES}

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        lib.conv3x3_packed_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]
        )
        lib.conv3x3_packed_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def packed_eligible(x_shape, kernel_size, strides, padding, dilation,
                    groups: int, row_tile: int = 64) -> bool:
    """Static eligibility, as the JAX package's: SAME stride-1 undilated 3×3,
    no feature groups, NHWC `x_shape` with W % 4 == 0, gcd(H, row_tile) ≥ 8
    and Cin == 32."""
    if tuple(kernel_size) != (3, 3) or groups != 1:
        return False
    if strides not in (None, 1, (1, 1)) or dilation not in (None, 1, (1, 1)):
        return False
    if not (padding == "SAME" or padding == [(1, 1), (1, 1)]
            or padding == ((1, 1), (1, 1))):
        return False
    if len(x_shape) != 4:
        return False
    _, h, wdt, cin = x_shape
    return wdt % 4 == 0 and math.gcd(h, row_tile) >= 8 and cin == 32


def _check(x: torch.Tensor, w_hwio: torch.Tensor):
    if x.dim() != 4 or w_hwio.dim() != 4 or tuple(w_hwio.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3_packed takes 4-D x and a (3,3,Cin,Cout) kernel, "
                         f"got {tuple(x.shape)}, {tuple(w_hwio.shape)}")
    if x.dtype != w_hwio.dtype:
        raise TypeError(f"conv3x3_packed: x is {x.dtype}, the kernel {w_hwio.dtype}")


def instance(dtype: torch.dtype) -> str:
    """The kernel instance a CUDA call in `dtype` launches now: "bf16" for
    bfloat16; for float32 "tf32" while `torch.backends.cudnn.allow_tf32` is
    set, else "f32"."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype != torch.float32:
        raise TypeError(f"conv3x3_packed takes float32 or bfloat16, got {dtype}")
    return "tf32" if torch.backends.cudnn.allow_tf32 else "f32"


def _launch(x: torch.Tensor, w_hwio: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """The kernel on x (NHWC if `channels_last`, else NCHW; any strides) and
    a (3,3,Cin,Cout) weight → y in the same layout, contiguous."""
    if x.device.type != "cuda" or w_hwio.device != x.device:
        raise ValueError(f"conv3x3_packed: no kernel for x on {x.device}, "
                         f"weights on {w_hwio.device}")
    inst = instance(x.dtype)
    if channels_last:
        b, h, wd, cin = x.shape
        sb, sh, sw, sc = x.stride()
    else:
        b, cin, h, wd = x.shape
        sb, sc, sh, sw = x.stride()
    cout = w_hwio.shape[3]
    if w_hwio.shape[2] != cin:
        raise ValueError(f"conv3x3_packed: x has {cin} channels, the kernel "
                         f"{w_hwio.shape[2]}")
    if min(b, h, wd, cin, cout) < 1:
        raise ValueError(f"conv3x3_packed: empty shape x {tuple(x.shape)}, "
                         f"kernel {tuple(w_hwio.shape)}")
    if b > _MAX_GRID_YZ or -(-h // _MIN_TILE_ROWS) > _MAX_GRID_YZ:
        raise ValueError(f"conv3x3_packed: batch {b} or height {h} past the grid limit")
    if max(x.numel(), b * h * wd * cout) >= 2**31:
        raise ValueError("conv3x3_packed: tensors of 2**31 elements or more")
    w_hwio = w_hwio.contiguous()
    if channels_last:
        y = torch.empty(b, h, wd, cout, dtype=x.dtype, device=x.device)
        ysb, ysh, ysw, ysc = y.stride()
    else:
        y = torch.empty(b, cout, h, wd, dtype=x.dtype, device=x.device)
        ysb, ysc, ysh, ysw = y.stride()
    lib = _kernel_lib()
    dev = x.device
    guard = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        # the raw handle: torch.cuda.current_stream() builds a Stream object
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = lib.conv3x3_packed_launch(
            x.data_ptr(), w_hwio.data_ptr(), y.data_ptr(), MODES[inst],
            b, h, wd, cin, cout, sb, sc, sh, sw, ysb, ysc, ysh, ysw, stream,
        )
    if err != 0:
        raise _build.KernelError(f"conv3x3_packed launch failed: cudaError {err}")
    _build.launches[KERNEL] += 1
    _build.launches[LAUNCH_KEYS[inst]] += 1
    return y


def _plain(x: torch.Tensor, w: torch.Tensor) -> bool:
    return x.device == w.device and x.device.type in ("cpu", "meta")


def conv3x3_packed_reference_nchw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the f32 (ieee) and bf16 instances, NCHW x
    and OIHW w: the convolution summed in f32, output in x.dtype. On the
    card it follows cuDNN's TF32 flag: hold the f32 instance to it with the
    flag off."""
    return F.conv2d(x.float(), w.float(), padding=1).to(x.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to the
    nearest value with 10 explicit mantissa bits, ties away from zero, by
    integer operations on the bits (the low 13 come out zero); inf and nan
    kept, finite values past TF32's largest become inf."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000  # in magnitude: sign apart, no wrap for finite values
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, rounded, bits).view(torch.float32)


def conv3x3_tf32_reference_nchw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the TF32 instance, NCHW x and OIHW w in float32: x
    and w rounded to TF32 (`tf32_round`), then convolved in f32 with TF32
    off, so cuDNN does not round them again; the products of TF32 values
    are exact in f32, so this differs from the kernel only by the order of
    the f32 sums."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(tf32_round(x.float()), tf32_round(w.float()), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv3x3_packed_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, NHWC x and HWIO w."""
    _check(x, w)
    y = conv3x3_packed_reference_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def conv3x3_packed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 conv, x (B,H,W,Cin), w (3,3,Cin,Cout) → (B,H,W,Cout) in
    x.dtype. CUDA tensors go through the kernel (or raise); CPU tensors
    through the plain version."""
    _check(x, w)
    if _plain(x, w):
        return conv3x3_packed_reference(x, w)
    return _launch(x, w, channels_last=True)


def conv3x3_packed_nchw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in the modules' layout: x (B,Cin,H,W), w
    (Cout,Cin,3,3) → (B,Cout,H,W) in x.dtype."""
    w_hwio = w.permute(2, 3, 1, 0)
    _check(x, w_hwio)
    if _plain(x, w):
        return conv3x3_packed_reference_nchw(x, w)
    return _launch(x, w_hwio, channels_last=False)


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """OIHW kernel of the input gradient of a SAME stride-1 3×3 conv: `w`
    flipped 180° with its channels transposed, (Cout,Cin,3,3) → (Cin,Cout,3,3)."""
    return w.flip(2, 3).transpose(0, 1)


class _PackedConv(torch.autograd.Function):
    """y = conv(x, w) NCHW/OIHW; dx through the kernel, dw from x and dy."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_packed_nchw(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_packed_nchw(dy, flip_transpose(w).to(dy.dtype)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, dy.to(x.dtype), padding=1)
        return dx, dw


def conv3x3_packed_trainable_nchw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`conv3x3_packed_nchw` with its gradient (see the module docstring)."""
    return _PackedConv.apply(x, w)


def conv3x3_packed_trainable(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`conv3x3_packed` with its gradient, NHWC x and HWIO w, as the JAX
    package's `conv3x3_packed_trainable`."""
    y = _PackedConv.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)
