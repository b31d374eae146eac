"""PNG export and the label colormap: the port's own copy of `save_image`
and `CMAP` from `medical_image_editing_tpu/utils/imaging.py` (reference
`src/utils/__init__.py:162-167`, `src/trainers/base.py:43`). matplotlib is
imported at first use."""

import numpy as np

CMAP = "Spectral"  # label-map colormap


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_image(image, cmap, vmin, vmax, path):
    """Single matplotlib imshow → PNG."""
    plt = _plt()
    plt.axis("off")
    plt.imshow(np.asarray(image), cmap=cmap, vmin=vmin, vmax=vmax)
    plt.savefig(path, bbox_inches="tight", dpi=300)
    plt.clf()
