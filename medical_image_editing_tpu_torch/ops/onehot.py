"""One-hot encoding, channels last.

Counterpart of `medical_image_editing_tpu/ops/onehot.py` (reference
`src/functions/onehot.py:11-20`).
"""

import torch


def one_hot(ids: torch.Tensor, n_classes: int, dtype=torch.float32) -> torch.Tensor:
    """Integer id map (B,H,W) → one-hot (B,H,W,K). The trainer drops the
    background channel afterwards (`[..., 1:]`); ids outside [0, K) give a
    zero row, as in the JAX function."""
    ids = ids.to(torch.int64)
    return (ids[..., None] == torch.arange(n_classes, device=ids.device)).to(dtype)
