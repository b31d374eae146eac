"""Datasets, the host batch loader with device prefetch, and the native
`.npy` batch reader: counterparts of the JAX package's `data/` modules
(the offline `preprocess.py` is not ported yet, ROADMAP item 12)."""

from .datasets import (
    CRCDataset,
    MICCAIBraTSDataset,
    NCCLungDataset,
    SyntheticSliceDataset,
)
from .loader import DataLoader, get_data_loader, prefetch_to_device
