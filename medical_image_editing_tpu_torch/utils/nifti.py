"""Minimal pure-numpy NIfTI-1 I/O (.nii / .nii.gz).

The port's own copy of `medical_image_editing_tpu/utils/nifti.py`.

The reference uses nibabel for all volume I/O (`src/utils/__init__.py:221-228`
`to_nifti`, `src/run_recon.py:83-95` load/save, `src/preprocess/*`). The
subset actually exercised is tiny, so no nibabel dependency is taken:
single-file NIfTI-1, identity affine, `get_fdata()` (float cast +
scl_slope/scl_inter scaling) and `save`. This module implements exactly that
subset with numpy — no external deps.

Layout convention matches nibabel: data returned in Fortran (i,j,k) axis order
as written in the file, i.e. `load(path)` == `nib.load(path).get_fdata()`.
"""

import gzip
import struct
from typing import Optional

import numpy as np

_HDR_SIZE = 348
_MAGIC = b"n+1\0"

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: str) -> np.ndarray:
    """Read a NIfTI-1 file → float64 array (nibabel `get_fdata()` parity)."""
    with _open(path, "rb") as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != _HDR_SIZE:
            sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
            if sizeof_hdr != _HDR_SIZE:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            endian = ">"

        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        magic = hdr[344:348]
        if magic not in (b"n+1\0", b"ni1\0"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        raw = f.read(count * np_dtype.itemsize)
        data = np.frombuffer(raw, dtype=np_dtype, count=count)
        # NIfTI stores Fortran order
        data = data.reshape(shape, order="F").astype(np.float64)

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    return data


def save(
    data: np.ndarray,
    path: str,
    affine: Optional[np.ndarray] = None,
    dtype=None,
) -> None:
    """Write a NIfTI-1 single file with the given (default identity) affine.

    Mirrors the reference's `nib.Nifti1Image(array, affine=np.eye(4))` +
    `nib.save` usage (`src/utils/__init__.py:221-228`, `run_recon.py:83-87`).
    """
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if dtype is not None:
        data = data.astype(dtype)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pixdim = [0.0] + [1.0] * 7

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    # sform: affine rows, sform_code = 1
    struct.pack_into("<h", hdr, 254, 1)
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = _MAGIC

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\0" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))


def to_nifti_array(array: np.ndarray) -> np.ndarray:
    """The reference's display-orientation transform before NIfTI export:
    transpose + double flip (`src/utils/__init__.py:221-228`)."""
    return np.transpose(array)[::-1, ::-1]
