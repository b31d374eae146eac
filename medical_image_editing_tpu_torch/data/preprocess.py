"""Offline preprocessing: raw NIfTI volumes → per-slice `.npy` files.

Counterpart of `medical_image_editing_tpu/data/preprocess.py`, host code with
no device work; its outputs (file names and arrays) are byte-identical to the
JAX package's. PIL resizes, as the reference does (SURVEY.md §7: PIL-bilinear
resize parity); NIfTI goes through the port's own `utils/nifti.py`.

  preprocess_crc            — `src/preprocess/preprocess_crc.py`: per volume
      min-max→[0,255], per slice flipud + rot90, PIL bilinear resize to 512².
  preprocess_brats          — `src/preprocess/preprocess_brats.py`: z-score
      normalize over the nonzero mask; seg label remap 4→3; rot90 k=3; 256²
      resize (NEAREST for seg, BILINEAR otherwise).
  make_crc_testing_dataset  — `src/preprocess/make_crc_testing_dataset.py`:
      CRC geometry, excluding the training patients.

Env-var configuration mirrors the reference's dotenv names; each function is
also directly callable with paths, and `main()` is an argparse CLI:

    python -m medical_image_editing_tpu_torch.data.preprocess crc --src RAW --dst OUT

The BraTS fan-out uses a thread pool instead of `multiprocessing.Pool(32)`
(numpy and PIL release the GIL).
"""

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from ..utils import nifti

CRC_IMAGE_SIZE = 512
BRATS_IMAGE_SIZE = 256

BRATS_MODALITIES = (
    {"name": "T1", "pattern": "t1", "save_pattern": "t1"},
    {"name": "T1CE", "pattern": "t1ce", "save_pattern": "t1ce"},
    {"name": "T2", "pattern": "t2", "save_pattern": "t2"},
    {"name": "FLAIR", "pattern": "flair", "save_pattern": "flair"},
    {"name": "SEG", "pattern": "seg", "save_pattern": "seg"},
)


def parse_patient_id(file_path: str) -> str:
    """First two underscore-separated tokens. Spec: `preprocess_crc.py:17-20`."""
    return "_".join(os.path.basename(file_path).split("_")[:2])


def minmax_normalize(image: np.ndarray, scale: float = 255.0) -> np.ndarray:
    """Volume-level min-max to [0, scale]. Spec: `preprocess_crc.py:23-29` (pure)."""
    a_min, a_max = image.min(), image.max()
    return (image - a_min) / (a_max - a_min) * scale


def z_score_normalize(array: np.ndarray) -> np.ndarray:
    """Normalize over the nonzero (brain) mask. Spec: `preprocess_brats.py:43-50`."""
    array = array.astype(np.float32)
    mask = array > 0
    return (array - np.mean(array[mask])) / np.std(array[mask])


def _resize(slice_2d: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return np.array(
        Image.fromarray(slice_2d).resize((size, size), resample=resample)
    )


def _crc_slice_geometry(img: np.ndarray) -> np.ndarray:
    """flipud then rot90. Spec: `preprocess_crc.py:44-45`."""
    return np.rot90(img[::-1, ...])


def preprocess_crc_volume(image_path: str, dst_root: str, image_size: int = CRC_IMAGE_SIZE):
    patient_id = parse_patient_id(image_path)
    image = minmax_normalize(nifti.load(image_path))
    save_dir = os.path.join(dst_root, patient_id)
    os.makedirs(save_dir, exist_ok=True)
    for i in range(image.shape[2]):
        img = _resize(_crc_slice_geometry(image[..., i]), image_size, nearest=False)
        np.save(os.path.join(save_dir, str(i).zfill(4) + ".npy"), img)


def preprocess_crc(
    src_root: Optional[str] = None,
    dst_root: Optional[str] = None,
    image_size: int = CRC_IMAGE_SIZE,
):
    """All `*_image.nii.gz` volumes under src_root. Spec: `preprocess_crc.py:32-62`."""
    src_root = src_root or os.environ.get("SRC_CRC_DIR_PATH")
    dst_root = dst_root or os.environ.get("DST_CRC_DIR_PATH")
    for image_file in sorted(glob.glob(os.path.join(src_root, "*_image.nii.gz"))):
        preprocess_crc_volume(image_file, dst_root, image_size)


def make_crc_testing_dataset(
    train_root: Optional[str] = None,
    candidate_root: Optional[str] = None,
    dst_root: Optional[str] = None,
    image_size: int = CRC_IMAGE_SIZE,
    expected_training_patients: Optional[int] = 289,
):
    """CRC test split: candidates minus training patients.
    Spec: `make_crc_testing_dataset.py:34-70` (incl. the 289-patient check)."""
    train_root = train_root or os.environ.get("TRAIN_DATA_DIR_PATH")
    candidate_root = candidate_root or os.environ.get("CANDIDATE_DIR_PATH")
    dst_root = dst_root or os.environ.get("DIST_DIR_PATH")
    training_patients = set(os.listdir(train_root))
    if expected_training_patients is not None:
        assert len(training_patients) == expected_training_patients, len(training_patients)
    for image_file in sorted(glob.glob(os.path.join(candidate_root, "*_image.nii.gz"))):
        if parse_patient_id(image_file) not in training_patients:
            preprocess_crc_volume(image_file, dst_root, image_size)


def preprocess_brats_patient(
    patient_id: str,
    src_root: str,
    dst_root: str,
    image_size: int = BRATS_IMAGE_SIZE,
    modalities: Sequence[dict] = BRATS_MODALITIES,
    remap_seg_labels: bool = True,
):
    """One BraTS patient, all modalities. Spec: `preprocess_brats.py:54-113`."""
    patient_dir = os.path.join(src_root, patient_id)
    dst_dir = os.path.join(dst_root, patient_id)
    os.makedirs(dst_dir, exist_ok=True)
    for modality in modalities:
        path = os.path.join(patient_dir, f"{patient_id}_{modality['pattern']}.nii.gz")
        series = nifti.load(path)
        is_seg = modality["name"] == "SEG"
        if is_seg:
            series = series.astype(np.int32)
            if remap_seg_labels:
                bincount = np.bincount(series.ravel())
                if len(bincount) > 3:
                    assert bincount[3] == 0  # label 3 unused pre-remap
                series[series == 4] = 3  # ET (GD-enhancing tumor)
        else:
            series = z_score_normalize(series)
        for i in range(series.shape[2]):
            sl = np.rot90(series[..., i], k=3)
            sl = _resize(sl, image_size, nearest=is_seg)
            np.save(
                os.path.join(
                    dst_dir,
                    f"{patient_id}_{modality['save_pattern']}_{str(i).zfill(4)}.npy",
                ),
                sl,
            )


def preprocess_brats(
    src_roots: Optional[Sequence[str]] = None,
    dst_root: Optional[str] = None,
    image_size: int = BRATS_IMAGE_SIZE,
    max_workers: int = 4,
):
    """HGG + LGG training sets, fan-out over patients. Spec: `preprocess_brats.py:117-124`."""
    if src_roots is None:
        src_roots = [
            p
            for p in (
                os.environ.get("TRAIN_HGG_SRC_PATH"),
                os.environ.get("TRAIN_LGG_SRC_PATH"),
            )
            if p
        ]
    dst_root = dst_root or os.environ.get("TRAIN_BRATS_DST_PATH")
    for src_root in src_roots:
        patients = sorted(os.listdir(src_root))
        remap = "Training" in src_root
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            list(
                pool.map(
                    lambda pid: preprocess_brats_patient(
                        pid, src_root, dst_root, image_size, remap_seg_labels=remap
                    ),
                    patients,
                )
            )


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Offline NIfTI→npy preprocessing")
    parser.add_argument("task", choices=["crc", "brats", "crc_test"])
    parser.add_argument("--src", nargs="*", default=None)
    parser.add_argument("--dst", default=None)
    parser.add_argument("--train-root", default=None)
    parser.add_argument("--image-size", type=int, default=None)
    args = parser.parse_args(argv)

    if args.task == "crc":
        preprocess_crc(args.src[0] if args.src else None, args.dst,
                       args.image_size or CRC_IMAGE_SIZE)
    elif args.task == "brats":
        preprocess_brats(args.src or None, args.dst, args.image_size or BRATS_IMAGE_SIZE)
    else:
        make_crc_testing_dataset(args.train_root, args.src[0] if args.src else None,
                                 args.dst, args.image_size or CRC_IMAGE_SIZE)


if __name__ == "__main__":
    main()
