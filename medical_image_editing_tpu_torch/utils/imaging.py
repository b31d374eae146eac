"""PNG export and the label colormap: the port's counterpart of `save_image`
and `CMAP` in `medical_image_editing_tpu/utils/imaging.py` (reference
`src/utils/__init__.py:162-167`, `src/trainers/base.py:43`).

The JAX package saves a matplotlib figure of the image (axes off, 300 dpi).
The port writes the image's own pixels with the standard library (`zlib`,
`struct`), so that serving needs no plotting package: one pixel per array
element, the colormap applied as matplotlib applies it (256 levels between
`vmin` and `vmax`; "gray" as 8-bit grayscale, "Spectral" as RGB from
matplotlib's eleven control colours; the bytes equal matplotlib's). The
other helpers of that module (`to_image`, `save_fused_image`, the grids) are
ROADMAP item 13.
"""

import struct
import zlib

import numpy as np

CMAP = "Spectral"  # label-map colormap

# matplotlib's `_Spectral_data` (ColorBrewer Spectral, 11 classes), RGB in [0, 1]
_SPECTRAL = np.array([
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97), (254, 224, 139),
    (255, 255, 191), (230, 245, 152), (171, 221, 164), (102, 194, 165),
    (50, 136, 189), (94, 79, 162),
]) / 255.0
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _lut(cmap: str) -> np.ndarray:
    """(256, 3) uint8 colour table of a colormap, as matplotlib builds it with
    N = 256 levels (linear between the control colours, bytes truncated)."""
    xs = np.linspace(0.0, 1.0, 256)
    if cmap == "gray":
        table = np.repeat(xs[:, None], 3, axis=1)
    elif cmap == "Spectral":
        stops = np.linspace(0.0, 1.0, len(_SPECTRAL))
        table = np.stack([np.interp(xs, stops, _SPECTRAL[:, ch]) for ch in range(3)], 1)
    else:
        raise ValueError(f"colormap {cmap!r}: 'gray' or 'Spectral'")
    return (table * 255).astype(np.uint8)


def colorize(image, cmap: str, vmin: float, vmax: float) -> np.ndarray:
    """(H, W) values → (H, W) uint8 levels ("gray") or (H, W, 3) uint8 RGB:
    level = floor((x − vmin) / (vmax − vmin) · 256) clipped to [0, 255], as
    matplotlib's `Normalize` and `Colormap` index their table. NaN → 0."""
    x = (np.asarray(image, dtype=np.float64) - vmin) / (vmax - vmin)
    level = np.clip(np.floor(np.nan_to_num(x, nan=0.0) * 256), 0, 255).astype(np.intp)
    rgb = _lut(cmap)[level]
    return rgb[..., 0] if cmap == "gray" else rgb


def encode_png(pixels: np.ndarray) -> bytes:
    """8-bit grayscale (H, W) or RGB (H, W, 3) uint8 → PNG bytes (filter 0,
    zlib level 6)."""
    a = np.ascontiguousarray(pixels, dtype=np.uint8)
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG pixels (H, W) or (H, W, 3), got {a.shape}")
    h, w = a.shape[:2]
    rows = np.hstack([np.zeros((h, 1), np.uint8), a.reshape(h, -1)])

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(image, cmap, vmin, vmax, path):
    """(H, W) values → PNG at `path`, one pixel per element, through `cmap`."""
    with open(path, "wb") as f:
        f.write(encode_png(colorize(image, cmap, vmin, vmax)))
