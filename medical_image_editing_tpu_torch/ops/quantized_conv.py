"""int8 post-training quantization of the convolutions, for the serving path.

Counterpart of `medical_image_editing_tpu/ops/quantized_conv.py`. Inside
`quantize_convs("int8")` every `models.blocks.Conv` runs `int8_conv`, the
JAX package's `int8_conv_call` operation by operation, on the module's own
f32 weight and bias (the same checkpoint serves f32, bf16 and int8):

  * activation scales per input channel over the whole tensor in flight
    (the batch, or a `microbatch` chunk): x_scale[c] =
    max(amax|x[:, c]|, 1e-12) / 127;
  * activation codes xq = clip(round_half_even(x / x_scale), -127, 127),
    with true division;
  * the scales folded into the weight, k_fold = W · x_scale[cin], and the
    weight's codes per output channel: k_scale[o] =
    max(amax|k_fold[o]|, 1e-12) / 127, kq = clip(round(k_fold / k_scale));
  * acc = Σ xq·kq in int32, then out = f32(acc) · k_scale[o] + bias[o] in
    two roundings, cast to the module's compute dtype (f32 when none).

On CUDA tensors `int8_conv` is four launches of the hand-written kernels of
`csrc/conv_s8.cu`: `channel_absmax`, `conv_s8_weights` (the scales and the
weight fold in one kernel), `quantize_s8` and `conv_s8` (an implicit GEMM on
`wgmma`; `conv_s8_instance` picks its tile); a build or launch failure
raises `KernelError`, with no fallback. PyTorch has no int8 convolution on
CUDA (`F.conv2d` refuses `torch.int8`), and the JAX package leaves this one
to XLA, not to a Pallas kernel. On CPU tensors the plain versions run
(`*_reference`, `weight_codes`): the activation passes and the fold as torch
ops and the int32 sums exactly, as `F.conv2d` in float64 on the
integer-valued codes (|acc| ≤ 127²·9·512 < 2⁵³), rounded to int32.
`int8_conv_reference` is the whole call in plain torch on any device; the
tests and `chip_smoke.py` hold the kernels to it.

Every scale is divided by a tensor, never by a Python number: on CUDA,
PyTorch divides by a scalar as a multiply by its reciprocal, which can move
a scale by one ulp and a code across a tie.

`quantize_convs(mode)`: None is a no-op, "int8" turns the path on, anything
else raises `ValueError`. The mode is thread-local, so a serving thread
never sees another thread's.
"""

import contextlib
import ctypes
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "conv_s8"                 # the convolution's launch count, and the source
ABSMAX = "conv_s8_absmax"          # the activation passes' launch counts
QUANTIZE = "conv_s8_quantize"
WEIGHTS = "conv_s8_weights"        # the weight fold's launch count
MODES = ("int8",)
K_STEP = 32  # the kernel's channels per K-step: codes are padded to a multiple
_MAX_GRID_YZ = 65535
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_state = threading.local()
_lib = None


def quantize_mode() -> Optional[str]:
    """The calling thread's quantization mode: None or "int8"."""
    return getattr(_state, "mode", None)


@contextlib.contextmanager
def quantize_convs(mode: Optional[str]):
    """While active, every `Conv` called on this thread runs `int8_conv`.
    `mode=None` is a no-op (call sites pass the setting straight through)."""
    if mode is None:
        yield
        return
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    prev = quantize_mode()
    _state.mode = mode
    try:
        yield
    finally:
        _state.mode = prev


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conv_s8_absmax_launch.argtypes = [vp, vp, i, i, i, ll, vp]
        lib.conv_s8_quantize_launch.argtypes = [vp, vp, vp, i, i, i, i, ll, vp]
        lib.conv_s8_weights_launch.argtypes = [vp] * 5 + [i] * 4 + [vp]
        lib.conv_s8_launch.argtypes = [vp] * 5 + [i] * 19 + [vp]
        for fn in (lib.conv_s8_absmax_launch, lib.conv_s8_quantize_launch,
                   lib.conv_s8_weights_launch, lib.conv_s8_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _plain(*tensors) -> bool:
    return all(t.device.type in ("cpu", "meta") for t in tensors)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_launch(name: str, err: int):
    if err != 0:
        raise _build.KernelError(f"{name} launch failed: cudaError {err}")
    _build.launches[name] += 1


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b with true division on every device (see the module note)."""
    return a / torch.full_like(a, b)


def padded_channels(c: int) -> int:
    """Channels of the codes: `c` rounded up to a multiple of `K_STEP`."""
    return -(-c // K_STEP) * K_STEP


def _check_x(x: torch.Tensor, what: str):
    if x.dim() != 4:
        raise ValueError(f"{what} takes an NCHW tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")


def _check_cuda(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for a tensor on {x.device}")
    if x.shape[0] > _MAX_GRID_YZ or x.shape[1] > _MAX_GRID_YZ:
        raise ValueError(f"{what}: batch {x.shape[0]} or channels {x.shape[1]} past "
                         f"{_MAX_GRID_YZ}")


# ---- activation scales --------------------------------------------------------

def channel_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: amax over (N, H, W) of |x|, (C,) f32."""
    return x.float().abs().amax((0, 2, 3))


def channel_absmax(x: torch.Tensor) -> torch.Tensor:
    """amax over (N, H, W) of |x| for NCHW f32/bf16 x → (C,) f32: the kernel
    on CUDA tensors, the plain version on CPU ones. Exact either way."""
    _check_x(x, "channel_absmax")
    if _plain(x):
        return channel_absmax_reference(x)
    _check_cuda(x, "channel_absmax")
    x = x.contiguous()
    n, c, h, w = x.shape
    amax = torch.zeros(c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return amax
    with torch.cuda.device(x.device):
        err = _kernel_lib().conv_s8_absmax_launch(
            x.data_ptr(), amax.data_ptr(), _IN_DTYPES[x.dtype], n, c, h * w, _stream(x.device))
    _check_launch(ABSMAX, err)
    return amax


def symmetric_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, as the JAX package's `_quantize_sym`."""
    return _div(amax.clamp_min(1e-12), 127.0)


# ---- activation codes ---------------------------------------------------------

def quantize_s8_reference(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: NCHW x, (C,) scale → (N, H, W, Cp) int8 codes, the
    channels past C zero."""
    n, c, h, w = x.shape
    q = torch.round(x.float() / scale[None, :, None, None]).clamp(-127, 127).to(torch.int8)
    out = torch.zeros(n, h, w, padded_channels(c), dtype=torch.int8, device=x.device)
    out[..., :c] = q.permute(0, 2, 3, 1)
    return out


def quantize_s8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(x / scale[c]), ±127) of NCHW f32/bf16 x →
    (N, H, W, Cp) int8, Cp = `padded_channels(C)`, zero past C: the kernel
    on CUDA tensors, the plain version on CPU ones."""
    _check_x(x, "quantize_s8")
    if scale.shape != (x.shape[1],) or scale.dtype != torch.float32:
        raise ValueError(f"quantize_s8: scale must be ({x.shape[1]},) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if _plain(x, scale):
        return quantize_s8_reference(x, scale)
    _check_cuda(x, "quantize_s8")
    x, scale = x.contiguous(), scale.contiguous()
    n, c, h, w = x.shape
    cp = padded_channels(c)
    q = torch.empty(n, h, w, cp, dtype=torch.int8, device=x.device)
    if q.numel() == 0:
        return q
    with torch.cuda.device(x.device):
        err = _kernel_lib().conv_s8_quantize_launch(
            x.data_ptr(), scale.data_ptr(), q.data_ptr(), _IN_DTYPES[x.dtype], n, c, cp,
            h * w, _stream(x.device))
    _check_launch(QUANTIZE, err)
    return q


# ---- weight codes -------------------------------------------------------------

def weight_codes(weight: torch.Tensor, x_scale: torch.Tensor):
    """Fold the activation scales into the OIHW weight and quantize it per
    output channel → (codes (kh·kw, Cout, Cp) int8, the kernel's layout,
    zero past Cin; k_scale (Cout,) f32). Plain torch ops on the weight's
    device."""
    k_fold = weight.float() * x_scale[None, :, None, None]
    k_scale = symmetric_scale(k_fold.abs().amax((1, 2, 3)))
    kq = torch.round(k_fold / k_scale[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    cout, cin, kh, kw = kq.shape
    codes = torch.zeros(kh * kw, cout, padded_channels(cin), dtype=torch.int8,
                        device=weight.device)
    codes[..., :cin] = kq.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin)
    return codes, k_scale


def conv_s8_weights_reference(weight: torch.Tensor, amax: torch.Tensor):
    """Plain version of `conv_s8_weights`: `symmetric_scale` of the
    activation maxima, then `weight_codes`."""
    x_scale = symmetric_scale(amax)
    codes, k_scale = weight_codes(weight, x_scale)
    return codes, k_scale, x_scale


def conv_s8_weights(weight: torch.Tensor, amax: torch.Tensor):
    """The activation scales and the weight fold from the OIHW f32 weight
    and the activation maxima (Cin,) → (codes (kh·kw, Cout, Cp) int8, k_scale
    (Cout,) f32, x_scale (Cin,) f32): one launch of the kernel on CUDA
    tensors, the plain version on CPU ones. Bit for bit either way."""
    if weight.dim() != 4 or amax.shape != (weight.shape[1],):
        raise ValueError(f"conv_s8_weights takes an OIHW weight and ({weight.shape[1]},) "
                         f"maxima, got {tuple(weight.shape)} and {tuple(amax.shape)}")
    if _plain(weight, amax):
        return conv_s8_weights_reference(weight, amax)
    if weight.device.type != "cuda" or amax.device != weight.device:
        raise ValueError(f"conv_s8_weights: no kernel for a weight on {weight.device}, "
                         f"maxima on {amax.device}")
    w = weight.float().contiguous()
    amax = amax.float().contiguous()
    cout, cin, kh, kw = w.shape
    cp = padded_channels(cin)
    codes = torch.empty(kh * kw, cout, cp, dtype=torch.int8, device=w.device)
    k_scale = torch.empty(cout, dtype=torch.float32, device=w.device)
    x_scale = torch.empty(cin, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _kernel_lib().conv_s8_weights_launch(
            w.data_ptr(), amax.data_ptr(), codes.data_ptr(), k_scale.data_ptr(),
            x_scale.data_ptr(), cout, cin, cp, kh * kw, _stream(w.device))
    _check_launch(WEIGHTS, err)
    return codes, k_scale, x_scale


# ---- the convolution ----------------------------------------------------------

def _output_size(size: int, k: int, d: int, p: int) -> int:
    return size + 2 * p - d * (k - 1)


ROW_PIXELS = 64  # the row kernel's pixels a warpgroup (csrc/conv_s8.cu's kRowM)
_SMEM_LIMIT = 232448


def row_kernel_smem(bn: int, kys: int, stages: int, cp: int, kh: int, dw: int) -> int:
    """Dynamic shared memory of a `conv_s8_kernel_rows` launch, as
    `csrc/conv_s8.cu::row_smem` reckons it: the ring (no more slots than
    steps) or the staged epilogue, and the alignment."""
    seg = ROW_PIXELS + 2 * dw
    slots = min(stages, kh // kys * (cp // K_STEP))
    return max(slots * kys * (2 * seg + 3 * bn) * K_STEP, bn * 132 * 4) + 128


def conv_s8_instance(cout: int, cp: int, kh: int, kw: int, dw: int, wo: int):
    """The `conv_s8` kernel and instance that take a convolution of `cout`
    output channels, `cp` padded input channels, a kh × kw kernel of
    dilation `dw` along the width and output width `wo`: (kernel, BN, KC,
    STAGES, PREFETCH), one of `csrc/conv_s8.cu`'s CONV_S8_INSTANCES.

    Kernel 1, `conv_s8_kernel_rows`, three kernel rows a step, when each
    warpgroup's 64 pixels are one run of an output row (wo % 64 == 0), the
    kernel is 3 × 3 (the taps of a kernel row share a row segment of 64 +
    2·dw pixels, at most 128), Cin is past 32 channels and the ring fits in
    shared memory; else kernel 0, `conv_s8_kernel`, two 32-byte chunks a
    stage. BN 32 and 64 for the bytes-bound Cout ≤ 64 convolutions, 128
    past them. The choice is `tools/conv_s8_sweep.py`'s at the lung
    decoder's shapes on an H100: at 32 channels in, the gather kernel's
    nine 4 KB tap tiles beat the row kernel's segments."""
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    rows = (1, bn, 3, 2, 1)
    if (kh == 3 and kw == 3 and wo % ROW_PIXELS == 0 and ROW_PIXELS + 2 * dw <= 2 * ROW_PIXELS
            and cp > K_STEP and row_kernel_smem(bn, *rows[2:4], cp, kh, dw) <= _SMEM_LIMIT):
        return rows
    return 0, bn, 2, 4, 2


def conv_s8_reference(xq: torch.Tensor, wq: torch.Tensor, k_scale: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], *, kernel_size: Sequence[int],
                      dilation: Sequence[int], padding: Sequence[int],
                      out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of `conv_s8`: the int32 sums exactly (float64 on the
    integer codes, rounded), then the same two-step epilogue."""
    kh, kw = kernel_size
    taps, cout, cp = wq.shape
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.reshape(kh, kw, cout, cp).permute(2, 3, 0, 1).double()
    acc = F.conv2d(x, w, padding=tuple(padding), dilation=tuple(dilation))
    acc = acc.round().to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    out = acc.float() * k_scale[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(out_dtype)


def conv_s8(xq: torch.Tensor, wq: torch.Tensor, k_scale: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], *, kernel_size: Sequence[int],
            dilation: Sequence[int], padding: Sequence[int],
            out_dtype=torch.float32) -> torch.Tensor:
    """Stride-1 convolution of the codes xq (N, H, W, Cp) int8 with wq
    (kh·kw, Cout, Cp) int8 → (N, Cout, Ho, Wo) in `out_dtype`: f32 or bf16
    f32(acc)·k_scale[o] (+ bias[o]), or int32 for the raw sums. The kernel
    on CUDA tensors, the plain version on CPU ones."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"conv_s8: out_dtype {out_dtype} is not float32, bfloat16 or int32")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 4 or wq.dim() != 3:
        raise ValueError(f"conv_s8 takes int8 codes (N,H,W,Cp) and (taps,Cout,Cp), got "
                         f"{xq.dtype} {tuple(xq.shape)}, {wq.dtype} {tuple(wq.shape)}")
    kh, kw = kernel_size
    (dh, dw), (ph, pw) = dilation, padding
    n, h, w, cp = xq.shape
    taps, cout, wcp = wq.shape
    if taps != kh * kw or wcp != cp or cp % K_STEP:
        raise ValueError(f"conv_s8: codes {tuple(xq.shape)} and weights {tuple(wq.shape)} "
                         f"do not fit a {kh}x{kw} kernel with channels padded to {K_STEP}")
    ho, wo = _output_size(h, kh, dh, ph), _output_size(w, kw, dw, pw)
    if ho < 1 or wo < 1:
        raise ValueError(f"conv_s8: empty output {ho}x{wo}")
    if out_dtype != torch.int32 and (k_scale is None or k_scale.shape != (cout,)):
        raise ValueError("conv_s8: a dequantized output needs k_scale of shape (Cout,)")
    if _plain(xq, wq):
        return conv_s8_reference(xq, wq, k_scale, bias, kernel_size=kernel_size,
                                 dilation=dilation, padding=padding, out_dtype=out_dtype)
    if xq.device.type != "cuda" or wq.device != xq.device:
        raise ValueError(f"conv_s8: no kernel for codes on {xq.device}, weights on {wq.device}")
    if max(h * w, ho * wo) >= 2**31 or cout > _MAX_GRID_YZ * 32:
        raise ValueError(f"conv_s8: images of 2**31 pixels or more, or {cout} channels")
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"conv_s8: bias of shape {tuple(bias.shape)}, not ({cout},)")
    xq, wq = xq.contiguous(), wq.contiguous()
    k_scale, bias = (None if t is None else t.to(xq.device, torch.float32).contiguous()
                     for t in (k_scale, bias))
    y = torch.empty(n, cout, ho, wo, dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _kernel_lib().conv_s8_launch(
            xq.data_ptr(), wq.data_ptr(), *(None if t is None else t.data_ptr()
                                            for t in (k_scale, bias)),
            y.data_ptr(), _OUT_DTYPES[out_dtype], n, h, w, cp, cout, ho, wo, kh, kw, dh, dw,
            ph, pw, *conv_s8_instance(cout, cp, kh, kw, dw, wo), _stream(xq.device))
    _check_launch(KERNEL, err)
    return y


# ---- the whole call -------------------------------------------------------------

def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_args(weight, stride, padding, dilation, groups):
    if tuple(_pair(stride)) != (1, 1) or groups != 1 or isinstance(padding, str):
        raise ValueError(f"int8_conv takes stride 1, one group and explicit padding; got "
                         f"stride {stride}, groups {groups}, padding {padding!r}")
    return dict(kernel_size=tuple(weight.shape[2:]), dilation=_pair(dilation),
                padding=_pair(padding))


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
              stride=1, padding=0, dilation=1, groups: int = 1,
              out_dtype=torch.float32, amax_reduce=None) -> torch.Tensor:
    """The int8 convolution of NCHW x with an OIHW f32 weight (and bias), in
    the module note's arithmetic → NCHW in `out_dtype`. CUDA tensors go
    through the kernels (or raise); CPU tensors through the plain versions.
    `amax_reduce`, where given, maps the activation maxima (Cin,) before the
    scales are taken from them: a sharded decode's maximum over its ranks
    (`VolumetricMesh.pmax`), so that the scales are the whole array's, as
    GSPMD takes them."""
    args = _conv_args(weight, stride, padding, dilation, groups)
    amax = channel_absmax(x)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    wq, k_scale, x_scale = conv_s8_weights(weight, amax)
    xq = quantize_s8(x, x_scale)
    return conv_s8(xq, wq, k_scale, bias, out_dtype=out_dtype, **args)


def int8_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *, stride=1, padding=0,
                        dilation=1, groups: int = 1, out_dtype=torch.float32,
                        amax_reduce=None) -> torch.Tensor:
    """Plain version of `int8_conv`, on any device."""
    args = _conv_args(weight, stride, padding, dilation, groups)
    amax = channel_absmax_reference(x)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    x_scale = symmetric_scale(amax)
    xq = quantize_s8_reference(x, x_scale)
    wq, k_scale = weight_codes(weight, x_scale)
    return conv_s8_reference(xq, wq, k_scale, bias, out_dtype=out_dtype, **args)
