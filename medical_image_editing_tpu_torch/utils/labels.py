"""The painted-label check of the editing entry points (fault C.1).

Kept apart from `cli/edit_batch.py` so that a process serving an exported
edit program (`cli/export_model.py::load_edit_artifact`) checks labels
without importing the models.
"""

import numpy as np
import torch


def check_labels(id_maps, dict_size: int) -> None:
    """Raise `ValueError` unless every painted label lies in
    [1 − dict_size, dict_size]: 0 is background, 1..K are codebook rows, and
    −K+1..−1 wrap to rows from the end as they do in the JAX package. A
    numpy array or CPU tensor is checked on the host; a CUDA tensor with one
    reduction and a sync."""
    if isinstance(id_maps, torch.Tensor):
        if id_maps.numel() == 0:
            return
        lo, hi = (int(v) for v in torch.stack(torch.aminmax(id_maps)).tolist())
    else:
        id_maps = np.asarray(id_maps)
        if id_maps.size == 0:
            return
        lo, hi = int(id_maps.min()), int(id_maps.max())
    if lo >= 1 - dict_size and hi <= dict_size:
        return
    if isinstance(id_maps, torch.Tensor):
        id_maps = id_maps.cpu().numpy()
    bad = np.unique(id_maps[(id_maps < 1 - dict_size) | (id_maps > dict_size)])
    raise ValueError(
        f"painted labels {bad[:8].tolist()}{' ...' if bad.size > 8 else ''} outside "
        f"[{1 - dict_size}, {dict_size}]: 0 is background, 1..{dict_size} the "
        "codebook's entries"
    )
