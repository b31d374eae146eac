"""CT/MR intensity windowing math.

Counterpart of `medical_image_editing_tpu/ops/windowing.py` (reference
`src/utils/__init__.py:17-51,81-92`). Every function works on torch tensors
and on numpy arrays alike: they use only arithmetic and a clamp.

Quirk kept from the reference: `t_normalize` does NOT clamp to the window —
it is the differentiable path used on reconstructions.
"""

from types import SimpleNamespace

import numpy as np

LUNG_WINDOW = SimpleNamespace(width=1500, center=-550, scale=2.0)


def _clip(image, vmin, vmax):
    if isinstance(image, np.ndarray):
        return image.clip(vmin, vmax)
    return image.clamp(vmin, vmax)


def _window_bounds(width, center):
    # `//` parity with the reference (integer window params).
    vmax = center + width // 2
    vmin = center - width // 2
    return vmin, vmax


def normalize(image, width=1500, center=-550, scale=2.0):
    """HU window → [-scale/2, scale/2], clipping outside the window."""
    vmin, vmax = _window_bounds(width, center)
    image = _clip(image, vmin, vmax)
    image = (image - vmin) / (vmax - vmin)
    return (image - 0.5) * scale


def t_normalize(image, width=1500, center=-550, scale=2.0):
    """Differentiable windowing: the affine map of `normalize`, no clamp."""
    vmin, vmax = _window_bounds(width, center)
    image = (image - vmin) / (vmax - vmin)
    return (image - 0.5) * scale


def denormalize(image, width, center, scale):
    """Inverse of `normalize` (modulo clipping)."""
    vmin, vmax = _window_bounds(width, center)
    image = image / scale + 0.5
    return image * (vmax - vmin) + vmin


def denorm(array, vmin, vmax):
    """[-1,1] → [vmin,vmax]."""
    return (array + 1.0) / 2.0 * (vmax - vmin) + vmin


def norm(array):
    """[0,1] → [-1,1]."""
    return array * 2.0 - 1.0


def normalize_intensity(image, vmin=0.0, vmax=255.0):
    """Clamp to [vmin,vmax] then map to [-1,1]."""
    image = _clip(image, vmin, vmax)
    image = (image - vmin) / (vmax - vmin)
    return image * 2.0 - 1.0
