"""File-walking datasets over preprocessed per-slice `.npy` files.

Counterpart of `medical_image_editing_tpu/data/datasets.py` (reference
`src/dataio/{lung,crc,miccai}_dataset.py`): the same walk (one
subdirectory per patient, sorted; files sorted within it), the same
slice-number parse from the filename tail, the same seeded shuffle of the
file list, and the HU windowing of lung slices at load (through the port's
`ops/windowing.py::normalize`).

Samples are dicts {patient_id, slice_num, image_path, image (H,W) float32}.
`SyntheticSliceDataset` serves tests and smoke runs.
"""

import glob
import os
import pathlib
import random
from typing import Optional

import numpy as np

from ..ops.windowing import normalize as window_normalize


def _parse_slice_num(path: str) -> int:
    return int(os.path.splitext(os.path.basename(path))[0].split("_")[-1])


class _SliceDataset:
    """Common walker: one subdirectory per patient, sorted slice files."""

    pattern = "*.npy"

    def __init__(self, root_dir_path: str, shuffle_files: bool = False, seed=None):
        self.root_dir_path = pathlib.Path(root_dir_path)
        self.files = self._build_file_paths()
        if shuffle_files:
            random.Random(seed).shuffle(self.files)

    def _glob_pattern(self) -> str:
        return self.pattern

    def _build_file_paths(self):
        files = []
        for patient_id in sorted(os.listdir(self.root_dir_path)):
            patient_dir = self.root_dir_path / patient_id
            if not patient_dir.is_dir():
                continue
            for image_path in sorted(glob.glob(str(patient_dir / self._glob_pattern()))):
                files.append({"patient_id": patient_id,
                              "slice_num": _parse_slice_num(image_path),
                              "image_path": image_path})
        return files

    def __len__(self):
        return len(self.files)

    def _load_image(self, path: str) -> np.ndarray:
        return np.load(path).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        sample = dict(self.files[index])
        sample["image"] = self._load_image(sample["image_path"])
        return sample


class NCCLungDataset(_SliceDataset):
    """Lung CT slices (`root/patient_id/*_img_*`), HU-windowed at load when
    the window is given. The file list is shuffled with `seed`."""

    pattern = "*_img_*"

    def __init__(
        self,
        root_dir_path: str,
        window_width: Optional[float] = None,
        window_center: Optional[float] = None,
        window_scale: Optional[float] = None,
        shuffle_files: bool = True,
        seed=None,
    ):
        super().__init__(root_dir_path, shuffle_files=shuffle_files, seed=seed)
        self.window = (
            (window_width, window_center, window_scale)
            if None not in (window_width, window_center, window_scale)
            else None
        )

    def __getitem__(self, index: int) -> dict:
        sample = super().__getitem__(index)
        if self.window is not None:
            w, c, s = self.window
            sample["image"] = np.asarray(
                window_normalize(sample["image"], width=w, center=c, scale=s),
                dtype=np.float32,
            )
        return sample


class CRCDataset(_SliceDataset):
    """Rectal-cancer T2 MR slices (0–255 valued), `root/patient_id/*.npy`."""

    pattern = "*.npy"

    def __init__(self, root_dir_path: str, shuffle_files: bool = True, seed=None):
        super().__init__(root_dir_path, shuffle_files=shuffle_files, seed=seed)


class MICCAIBraTSDataset(_SliceDataset):
    """BraTS slices filtered by modality (`*_{modality}_*`)."""

    MODALITIES = ("t1", "t1ce", "t2", "flair")

    def __init__(self, root_dir_path: str, modality: str, shuffle_files: bool = False,
                 seed=None):
        if modality not in self.MODALITIES:
            raise ValueError(f"modality {modality!r}: one of {self.MODALITIES}")
        self.modality = modality
        super().__init__(root_dir_path, shuffle_files=shuffle_files, seed=seed)

    def _glob_pattern(self) -> str:
        return f"*_{self.modality}_*"


class SyntheticSliceDataset:
    """In-memory random slices for tests and smoke runs."""

    def __init__(self, n: int = 32, size: int = 64, vmin=-1.0, vmax=1.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self._images = rng.uniform(vmin, vmax, (n, size, size)).astype(np.float32)
        self.files = [
            {"patient_id": f"synthetic_{i // 8:03d}", "slice_num": i % 8, "image_path": ""}
            for i in range(n)
        ]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        sample = dict(self.files[index])
        sample["image"] = self._images[index]
        return sample
