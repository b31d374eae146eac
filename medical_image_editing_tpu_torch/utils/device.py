"""Device resolution and the f32 convolution precision of the port's entry
points."""

import os

import torch

CONV_PRECISIONS = ("tf32", "ieee")
DEFAULT_CONV_PRECISION = "tf32"


def resolve_device(device="cuda") -> torch.device:
    """`torch.device(device)`, refusing a CUDA device on a host without one:
    the entry points default to "cuda", so running on the CPU is asked for
    explicitly and never happens by fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def apply_conv_precision() -> str:
    """Set the precision of cuDNN's f32 convolutions from
    `MEDIMG_CONV_PRECISION`: "tf32" (the default, what PyTorch runs
    unasked and what the reference ran) or "ieee" (full f32). Matmuls stay
    at full f32 either way. Returns the value applied; an unknown value
    raises ValueError. Each CLI calls this first.

    One API only, the `allow_tf32` flags: PyTorch's newer
    `fp32_precision` settings, mixed with them, can leave the two
    disagreeing or make a later read of `allow_tf32` raise."""
    value = os.environ.get("MEDIMG_CONV_PRECISION", DEFAULT_CONV_PRECISION)
    if value not in CONV_PRECISIONS:
        raise ValueError(f"MEDIMG_CONV_PRECISION={value!r} is not one of {CONV_PRECISIONS}")
    torch.backends.cudnn.allow_tf32 = value == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = False
    return value
