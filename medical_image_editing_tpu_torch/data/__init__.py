"""Datasets, the host batch loader with device prefetch, the native `.npy`
batch reader and the offline NIfTI preprocessing (`preprocess.py`):
counterparts of the JAX package's `data/` modules."""

from .datasets import (
    CRCDataset,
    MICCAIBraTSDataset,
    NCCLungDataset,
    SyntheticSliceDataset,
)
from .loader import DataLoader, get_data_loader, prefetch_to_device
