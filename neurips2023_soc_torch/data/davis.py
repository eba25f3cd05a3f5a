"""Ref-DAVIS-17 dataset, inference only (the port's copy of
neurips2023_soc_tpu/data/davis.py; reference datasets/davis/refer_davis.py and
infer_davis.py:190-256). Expressions come 4 per object (two annotators, a
first-frame and a full-video description each); evaluation merges the
per-object masks of each annotation variant by an argmax over objects. PIL
is imported where frames are read."""
from __future__ import annotations

import json
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .collate import frames_to_uint8
from .transforms import VideoTransforms


class ReferDAVISDataset:
    """One sample per (video, expression): the full frame sequence and its
    metadata; the inference engine chunks the clip."""

    def __init__(self, subset_type: str = "valid", dataset_path: str = "data/ref_davis",
                 transforms_kwargs: Optional[Dict] = None):
        self.dataset_path = dataset_path
        self.videos_dir = path.join(dataset_path, "valid", "JPEGImages")
        meta = path.join(dataset_path, "meta_expressions", "valid", "meta_expressions.json")
        with open(meta) as f:
            by_video = json.load(f)["videos"]
        self.samples_list: List[Tuple] = []
        for vid_id, data in by_video.items():
            frames = sorted(data["frames"])
            for exp_id, exp in data["expressions"].items():
                self.samples_list.append((vid_id, frames, dict(exp, exp_id=exp_id)))
        self.transforms = VideoTransforms("test", **(transforms_kwargs or {}))

    def __len__(self):
        return len(self.samples_list)

    def get_text(self, idx: int) -> str:
        """The expression text as __getitem__ yields it (test transforms never
        alter text), without decoding the frames: the inference loop fetches
        all of a video's expressions and decodes its frames once."""
        return " ".join(self.samples_list[idx][2]["exp"].lower().split())

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        vid_id, frame_indices, exp = self.samples_list[idx]
        text = self.get_text(idx)
        frames = [
            np.asarray(Image.open(path.join(self.videos_dir, vid_id, f"{i}.jpg"))
                       .convert("RGB"), np.float32) / 255.0
            for i in frame_indices
        ]
        orig_size = frames[0].shape[:2]
        frames, _, _, text = self.transforms(frames, None, None, text)
        return {
            # raw uint8 frames: the inference engine normalizes them on the device
            "frames": frames_to_uint8(frames),
            "text": text,
            "video_metadata": {
                "video_id": vid_id,
                "frame_indices": list(frame_indices),
                "resized_frame_size": tuple(frames[0].shape[:2]),
                "original_frame_size": tuple(orig_size),
                "exp_id": exp["exp_id"],
            },
        }
