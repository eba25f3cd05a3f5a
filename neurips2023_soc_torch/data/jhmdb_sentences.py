"""JHMDB-Sentences dataset, evaluation only (the port's copy of
neurips2023_soc_tpu/data/jhmdb_sentences.py; reference
datasets/jhmdb_sentences/jhmdb_sentences_dataset.py, whose train split is a
stub).

The sample index takes 3 random frames of each annotated video; masks come
from puppet_mask.mat; the A2D transforms are reused. PIL and scipy.io are
imported by the functions that read files.
"""
from __future__ import annotations

import json
import random
from glob import glob
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .collate import normalize_frames
from .transforms import VideoTransforms


def get_image_id(video_id: str, frame_idx: int) -> str:
    return f"v_{video_id}_f_{frame_idx}"


def build_samples_metadata(dataset_path: str, cache_dir: Optional[str] = None,
                           seed: int = 42, force_rebuild: bool = False) -> List[Tuple]:
    """(video_id, frame_path, masks_path, frame_idx, text) for 3 random
    frames of each video with a text annotation (reference
    jhmdb_sentences_dataset.py:44-76), cached as JSON; `force_rebuild`
    ignores an existing cache (the reference's
    `generate_new_samples_metadata`)."""
    cache = path.join(cache_dir or dataset_path, "jhmdb_sentences_samples_metadata.json")
    if path.exists(cache) and not force_rebuild:
        with open(cache) as f:
            return [tuple(a) for a in json.load(f)]
    import scipy.io

    with open(path.join(dataset_path, "jhmdb_annotation.txt")) as f:
        text_annotations = f.read().splitlines()[1:]
    assert len(text_annotations) == 928, "error: jhmdb_annotation.txt is missing samples"
    rng = random.Random(seed)
    samples = []
    for line in text_annotations:
        video_id, text = line.split(",", 1)
        video_masks_path = glob(
            path.join(dataset_path, "puppet_mask", "*", video_id, "puppet_mask.mat"))[0]
        video_frames = sorted(glob(path.join(
            dataset_path, "Rename_Images", "*", video_id, "*.png")))
        masks = scipy.io.loadmat(video_masks_path)["part_mask"]
        n_annotated = masks.shape[-1]
        for frame_idx in rng.sample(range(n_annotated), min(3, n_annotated)):
            samples.append((video_id, str(video_frames[frame_idx]), video_masks_path,
                            frame_idx, text.lower()))
    try:
        with open(cache, "w") as f:
            json.dump(samples, f)
    except OSError:  # a read-only dataset tree: the index is rebuilt next time
        pass
    return samples


class JHMDBSentencesDataset:
    def __init__(self, subset_type: str = "test", dataset_path: str = "data/jhmdb_sentences",
                 window_size: int = 8, transforms_kwargs: Optional[Dict] = None,
                 cache_dir: Optional[str] = None, force_rebuild_metadata: bool = False):
        assert subset_type == "test", "JHMDB-Sentences is evaluation-only"
        self.window_size = window_size
        self.samples_metadata = build_samples_metadata(
            dataset_path, cache_dir, force_rebuild=force_rebuild_metadata)
        self.transforms = VideoTransforms("test", **(transforms_kwargs or {}))

    def __len__(self):
        return len(self.samples_metadata)

    def __getitem__(self, idx: int) -> Dict:
        import scipy.io
        from PIL import Image

        video_id, frame_path, masks_path, frame_idx, text = self.samples_metadata[idx]
        text = " ".join(text.lower().split())
        masks = scipy.io.loadmat(masks_path)["part_mask"]

        # the window centred on the chosen frame; trailing frames without
        # masks are cut before windowing, as the reference's
        # video_frames_paths[:video_total_masks] (jhmdb_sentences_dataset.py:65-68,
        # 104-105), so edge clamping repeats the last annotated frame
        all_frames = sorted(glob(path.join(path.dirname(frame_path), "*.png")))
        all_frames = all_frames[: masks.shape[-1]]
        pos = all_frames.index(frame_path)
        start = pos - self.window_size // 2
        end = pos + (self.window_size + 1) // 2
        frames = []
        for i in range(start, end):
            i = min(max(i, 0), len(all_frames) - 1)
            frames.append(np.asarray(Image.open(all_frames[i]).convert("RGB"), np.float32)
                          / 255.0)

        mask = masks[..., frame_idx].astype(np.uint8)  # (H, W)
        h, w = mask.shape
        if mask.any():
            ys, xs = np.nonzero(mask)
            box = np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
        else:
            box = np.zeros(4, np.float32)
        frames, m, b, text = self.transforms(frames, mask[None, None], box[None, None], text)
        return {
            "frames": normalize_frames(np.stack(frames)),
            "text": text,
            "masks": m,
            "boxes": b,
            "labels": np.zeros(1, np.int32),
            "is_visible": np.array([[bool(mask.any())]]),
            "referred_instance_idx": 0,
            "valid_frame_idx": self.window_size // 2,
            "image_id": get_image_id(video_id, frame_idx),
            "orig_size": (h, w),
        }
