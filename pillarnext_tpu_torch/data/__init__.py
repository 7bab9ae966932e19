"""Host-side data (counterparts of pillarnext_tpu/data): datasets, GT-paste
sampling, augmentations, target assignment, static-shape collation and the
loader.  NumPy end to end; the scorers are ``nuscenes_eval`` and
``waymo_eval``."""

from pillarnext_tpu_torch.data.assign import AssignLabel
from pillarnext_tpu_torch.data.augmentation import Flip, Rotation, Scaling, Translation
from pillarnext_tpu_torch.data.collate import collate, pad_points
from pillarnext_tpu_torch.data.datasets import BaseDataset, NuScenesDataset, WaymoDataset
from pillarnext_tpu_torch.data.loader import DataLoader, build_dataloader
from pillarnext_tpu_torch.data.sampler import (
    BatchSampler,
    DataBaseSampler,
    DBFilterByMinNumPoint,
)

__all__ = [
    "AssignLabel",
    "BaseDataset",
    "BatchSampler",
    "DataBaseSampler",
    "DBFilterByMinNumPoint",
    "DataLoader",
    "Flip",
    "NuScenesDataset",
    "Rotation",
    "Scaling",
    "Translation",
    "WaymoDataset",
    "build_dataloader",
    "collate",
    "pad_points",
]
