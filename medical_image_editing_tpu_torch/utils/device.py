"""Device resolution for the port's entry points."""

import torch


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
