"""Experiment logging: versioned run dirs, CSV metric logs, config dumps.

Counterpart of `medical_image_editing_tpu/utils/logging.py` (reference
`src/utils/logger.py`), with the same files: run directories
`save_dir/study_name/version_N` with auto-incremented versions; train
metrics appended to `log.csv` in the fixed column order of the config's
`monitoring_metrics` (a missing key is an empty cell); `val_logs.csv` and
`test_logs.csv` with a header on first write; `config.json` with the config,
the seed list and the run directory. Every write is process-0-only.
"""

import json
import os
from typing import Dict, List, Optional

import numpy as np


def is_main_process() -> bool:
    """Rank-zero gate: `torch.distributed`'s rank when a process group is
    initialised, else True."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class Logger:
    def __init__(
        self,
        save_dir: str,
        config=None,
        monitoring_metrics: Optional[List[str]] = None,
        uploader=None,
        name: str = "default",
        version: Optional[int] = None,
    ):
        self._save_dir = save_dir
        self._name = name or ""
        self._config = config
        self._monitoring_metrics = list(monitoring_metrics or [])
        self._uploader = uploader
        self._version = version

    # -- directory layout ----------------------------------------------------
    @property
    def save_dir(self) -> str:
        return self._save_dir

    @property
    def name(self) -> str:
        return self._name

    @property
    def root_dir(self) -> str:
        if not self._name:
            return self._save_dir
        return os.path.join(self._save_dir, self._name)

    @property
    def version(self) -> int:
        if self._version is None:
            self._version = self._get_next_version()
        return self._version

    def _get_next_version(self) -> int:
        try:
            entries = os.listdir(self.root_dir)
        except OSError:
            return 0
        versions = []
        for bn in entries:
            if bn.startswith("version_") and os.path.isdir(os.path.join(self.root_dir, bn)):
                try:
                    versions.append(int(bn.split("_")[1]))
                except ValueError:
                    pass
        return max(versions) + 1 if versions else 0

    @property
    def log_dir(self) -> str:
        return os.path.expanduser(
            os.path.expandvars(os.path.join(self.root_dir, f"version_{self.version}"))
        )

    # -- metric CSVs ----------------------------------------------------------
    def _append_csv(self, fname: str, columns, values):
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, fname)
        with open(path, "a") as f:
            if f.tell() == 0:
                print(",".join(columns), file=f)
            print(",".join(values), file=f)
        return path

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None):
        """Train metrics in the fixed `monitoring_metrics` column order;
        missing keys log as empty cells."""
        if not is_main_process():
            return
        values = []
        for key in self._monitoring_metrics:
            v = metrics.get(key, "")
            if v != "":
                v = str(float(np.asarray(v).sum()))
            values.append(v)
        path = self._append_csv("log.csv", self._monitoring_metrics, values)
        if self._uploader is not None:
            try:
                self._uploader.send_image(path, message="log")
            except Exception:
                pass  # an upload never stops training (reference parity)

    def log_val_metrics(self, metrics: Dict[str, float]):
        if not is_main_process():
            return
        self._append_csv("val_logs.csv", list(metrics.keys()),
                         [str(v) for v in metrics.values()])

    def log_test_metrics(self, metrics: Dict[str, float]):
        if not is_main_process():
            return
        path = self._append_csv("test_logs.csv", list(metrics.keys()),
                                [str(v) for v in metrics.values()])
        print(f"Test results are saved: {path}")

    # -- config dump ----------------------------------------------------------
    def log_hyperparams(self, seed_list):
        if not is_main_process():
            return
        cfg = (self._config.to_dict() if hasattr(self._config, "to_dict")
               else dict(self._config or {}))
        cfg["seed_list"] = list(seed_list)
        cfg["save_dir_path"] = self.log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(cfg, f, ensure_ascii=False, indent=2, separators=(",", ": "))

    def log_images(self, image_name: str, images, current_epoch: int,
                   global_step: int, nrow: int = 8):
        """Tiled PNG grid of (B,H,W,C) images in [0, 1] (torchvision
        `save_image` semantics)."""
        if not is_main_process():
            return
        from .imaging import save_image_grid

        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir,
                            f"{image_name}_{current_epoch:04d}_{global_step:06d}.png")
        save_image_grid(images, path, nrow=nrow)
