from .collate import IMAGENET_MEAN, IMAGENET_STD, collate_batch, normalize_frames
from .synthetic import SyntheticRVOSDataset, iterate_batches

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "SyntheticRVOSDataset",
    "collate_batch",
    "iterate_batches",
    "normalize_frames",
]
