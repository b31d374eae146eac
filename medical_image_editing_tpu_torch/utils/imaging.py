"""PNG export and the label colormap: the port's counterpart of
`medical_image_editing_tpu/utils/imaging.py` (reference
`src/utils/__init__.py:67-78,162-189`, `src/trainers/base.py:43`).

The JAX package saves matplotlib figures (axes off, 300 dpi). The port
writes the images' own pixels with the standard library (`zlib`, `struct`),
so that neither serving nor training needs a plotting package (the card's
machine has none): one pixel per array element, the colormap applied as
matplotlib applies it (256 levels between `vmin` and `vmax`; "gray" as 8-bit
grayscale, "Spectral" as RGB from matplotlib's eleven control colours; the
bytes equal matplotlib's).

The snapshot and validation grids (`compose_grid`, `save_snapshot_grid`,
matplotlib's `subplot_image` cells in the JAX package) keep the panels'
order and the n_row × n_col layout, one panel per cell at its own pixel
size; the panels' titles are dropped (the standard library draws no text).
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


def as_numpy(array) -> np.ndarray:
    """Array or torch tensor (on any device; bf16 as f32) → numpy."""
    if hasattr(array, "detach"):
        array = array.detach().cpu()
        if str(array.dtype) == "torch.bfloat16":  # numpy has no bf16
            array = array.float()
        array = array.numpy()
    return np.asarray(array)


def to_image(array, is_ids: bool = False, retain_batch: bool = False):
    """Array or tensor → numpy for display. NHWC: images (B,H,W,C) → the
    first sample's first channel; id maps (B,H,W) → the first sample."""
    array = as_numpy(array)
    if retain_batch:
        return array if is_ids else array[..., 0]
    return array[0] if is_ids else array[0, ..., 0]


def _rgb(image, cmap, vmin, vmax) -> np.ndarray:
    """(H, W) → (H, W, 3) uint8 through `cmap`; vmin/vmax None take the
    image's min/max, and a flat range maps to the lowest level, as
    matplotlib's imshow does."""
    image = as_numpy(image).astype(np.float64)
    vmin = image.min() if vmin is None else vmin
    vmax = image.max() if vmax is None else vmax
    if vmax == vmin:
        level = colorize(np.zeros_like(image), cmap, 0.0, 1.0)
    else:
        level = colorize(image, cmap, vmin, vmax)
    return np.repeat(level[..., None], 3, axis=2) if level.ndim == 2 else level


def save_fused_image(image1, cmap1, vmin1, vmax1, image2, cmap2, vmin2, vmax2,
                     alpha, path):
    """Label overlay: image2 through cmap2 alpha-blended over image1."""
    base = _rgb(image1, cmap1, vmin1, vmax1).astype(np.float64)
    over = _rgb(image2, cmap2, vmin2, vmax2).astype(np.float64)
    fused = np.round((1.0 - alpha) * base + alpha * over).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(fused))


def compose_grid(panels, n_row: int, n_col: int, pad: int = 2) -> np.ndarray:
    """(image, cmap, vmin, vmax, cell) panels → one RGB uint8 grid of
    n_row × n_col cells, `cell` 1-based in row-major order (matplotlib's
    `subplot(n_row, n_col, cell)`); cells are as large as the largest panel,
    `pad` white pixels apart, and cells without a panel stay white."""
    rgbs = [(_rgb(im, cmap, vmin, vmax), z) for im, cmap, vmin, vmax, z in panels]
    h = max(r.shape[0] for r, _ in rgbs)
    w = max(r.shape[1] for r, _ in rgbs)
    grid = np.full((n_row * (h + pad) + pad, n_col * (w + pad) + pad, 3), 255, np.uint8)
    for rgb, z in rgbs:
        r, c = divmod(int(z) - 1, n_col)
        y0, x0 = pad + r * (h + pad), pad + c * (w + pad)
        grid[y0:y0 + rgb.shape[0], x0:x0 + rgb.shape[1]] = rgb
    return grid


def save_snapshot_grid(path: str, panels, n_row: int, n_col: int):
    """Write a grid of (image, title, cmap, vmin, vmax, cell) panels to a PNG
    (the trainers' snapshot plotting). Titles are dropped."""
    grid = compose_grid([(im, cmap, vmin, vmax, z) for im, _, cmap, vmin, vmax, z in panels],
                        n_row, n_col)
    with open(path, "wb") as f:
        f.write(encode_png(grid))


def save_image_grid(images, path: str, nrow: int = 8, pad: int = 2,
                    pad_value: float = 0.0):
    """Tile (B,H,W,C) images in [0, 1] into one PNG (torchvision `save_image`
    semantics, used by `Logger.log_images`)."""
    images = as_numpy(images).astype(np.float32)
    if images.ndim == 3:
        images = images[..., None]
    b, h, w, c = images.shape
    ncol = min(nrow, b)
    nrow_ = (b + ncol - 1) // ncol
    grid = np.full((nrow_ * (h + pad) + pad, ncol * (w + pad) + pad, c), pad_value,
                   np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    grid = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(grid[..., 0] if c == 1 else grid))
