"""Synthetic RVOS dataset: deterministic clips of two moving squares with a
referring expression naming one (the port's numpy copy of
neurips2023_soc_tpu/data/synthetic.py, the same samples for the same seed).
It lets the training path run without a licensed dataset mounted.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .collate import collate_batch, normalize_frames

_COLORS = {"red": (0.9, 0.1, 0.1), "green": (0.1, 0.8, 0.2), "blue": (0.15, 0.2, 0.9)}
_DIRS = {"left": (-1, 0), "right": (1, 0), "down": (0, 1), "up": (0, -1)}


class SyntheticRVOSDataset:
    """Each sample: a clip with two moving squares; the text refers to one."""

    def __init__(self, num_samples: int = 64, num_frames: int = 8,
                 frame_size: Tuple[int, int] = (96, 160), seed: int = 0,
                 center_frame_only: bool = False):
        self.num_samples = num_samples
        self.num_frames = num_frames
        self.frame_size = frame_size
        self.seed = seed
        self.center_frame_only = center_frame_only

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        T = self.num_frames
        h, w = self.frame_size
        colors = rng.permutation(list(_COLORS))[:2]
        dirs = [list(_DIRS)[rng.randint(4)] for _ in range(2)]
        ref = rng.randint(2)

        frames = np.zeros((T, h, w, 3), np.float32)
        masks = np.zeros((T, 2, h, w), np.uint8)
        boxes = np.zeros((T, 2, 4), np.float32)
        visible = np.zeros((T, 2), bool)
        size = rng.randint(h // 6, h // 3, size=2)
        pos = np.stack(
            [rng.randint(0, w - size.max(), 2), rng.randint(0, h - size.max(), 2)], -1
        ).astype(np.float32)  # (2, [x, y])
        vel = np.array([_DIRS[d] for d in dirs], np.float32) * (2 + rng.rand(2, 1) * 3)

        for t in range(T):
            for k in range(2):
                x0, y0 = pos[k] + vel[k] * t
                x1, y1 = x0 + size[k], y0 + size[k]
                xi0, yi0 = int(max(x0, 0)), int(max(y0, 0))
                xi1, yi1 = int(min(x1, w)), int(min(y1, h))
                if xi1 > xi0 and yi1 > yi0:
                    frames[t, yi0:yi1, xi0:xi1] = _COLORS[colors[k]]
                    masks[t, k, yi0:yi1, xi0:xi1] = 1
                    boxes[t, k] = (xi0, yi0, xi1, yi1)
                    visible[t, k] = True

        sample = {
            "frames": normalize_frames(frames),
            "text": f"the {colors[ref]} square moving {dirs[ref]}",
            # one referred instance, like the reference's video datasets
            "masks": masks[:, ref:ref + 1],
            "boxes": boxes[:, ref:ref + 1],
            "labels": np.zeros(1, np.int32),
            "is_visible": visible[:, ref:ref + 1],
            "referred_instance_idx": 0,
        }
        if self.center_frame_only:
            # A2D-style: only the center frame is annotated
            c = T // 2
            sample["valid_frame_idx"] = c
            sample["masks"] = sample["masks"][c:c + 1]
            sample["boxes"] = sample["boxes"][c:c + 1]
            sample["is_visible"] = sample["is_visible"][c:c + 1]
            sample["image_id"] = f"synthetic_{idx}"
            sample["orig_size"] = (h, w)
        return sample


def iterate_batches(dataset, batch_size: int, tokenizer, shuffle: bool = True,
                    seed: int = 0, **collate_kw):
    """Collated batches of `batch_size` in a seeded shuffled order; the
    ragged tail is dropped."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, len(order) - batch_size + 1, batch_size):
        samples = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield collate_batch(samples, tokenizer, **collate_kw)
