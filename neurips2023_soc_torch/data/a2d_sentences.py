"""A2D-Sentences dataset (the port's copy of
neurips2023_soc_tpu/data/a2d_sentences.py; reference datasets/a2d_sentences/).

The text-annotation index is built from Release/videoset.csv and
a2d_annotation.txt (cached as JSON); each item is a window of the source mp4
centred on one annotated frame, with the referred instance's h5 mask for that
frame only. cv2, h5py and pandas are imported by the functions that read
files.
"""
from __future__ import annotations

import json
from glob import glob
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .collate import normalize_frames
from .transforms import VideoTransforms, stable_rng


def get_image_id(video_id: str, frame_idx: int, ref_instance_a2d_id: int) -> str:
    """Unique eval image id (reference a2d_sentences_dataset.py:21-26)."""
    return f"v_{video_id}_f_{frame_idx}_i_{ref_instance_a2d_id}"


def read_video_frames_cv2(video_path: str, start: Optional[int] = None,
                          end: Optional[int] = None) -> np.ndarray:
    """Decode frames [start, end) of a video file to (T, H, W, 3) float32
    RGB in [0, 1]; the whole video when no range is given. Seeking with
    CAP_PROP_POS_FRAMES decodes only the window."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if start is not None and start > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        # seek can silently fail on some containers: verify, else grab forward
        if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start:
            cap.release()
            cap = cv2.VideoCapture(video_path)
            for _ in range(start):
                cap.grab()
    n = None if end is None else end - (start or 0)
    frames = []
    while n is None or len(frames) < n:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:  # seek past the real end (metadata overestimate) or a bad file
        return np.empty((0, 0, 0, 3), np.float32)
    return np.stack(frames).astype(np.float32) / 255.0


def video_frame_count(video_path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(video_path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def build_text_annotations(root_path: str, subset: str, cache_dir: Optional[str] = None,
                           force_rebuild: bool = False) -> List[Tuple]:
    """(text, video_id, frame_idx, instance_id) tuples (reference
    a2d_sentences_dataset.py:53-103), cached as JSON beside the data;
    `force_rebuild` ignores an existing cache (the reference's
    `generate_new_samples_metadata`)."""
    cache = path.join(cache_dir or root_path,
                      f"a2d_sentences_single_frame_{subset}_annotations.json")
    if path.exists(cache) and not force_rebuild:
        with open(cache) as f:
            return [tuple(a) for a in json.load(f)]
    import h5py
    import pandas

    info = pandas.read_csv(path.join(root_path, "Release/videoset.csv"), header=None)
    assert len(info) == 3782, "error: a2d videoset.csv is missing samples"
    info.columns = ["vid", "", "", "", "", "", "", "", "subset"]
    with open(path.join(root_path, "text_annotations/a2d_missed_videos.txt")) as f:
        unused = f.read().splitlines()
    subsets = {"train": 0, "test": 1}
    used = info[~info.vid.isin(unused) & (info.subset == subsets[subset])]
    used_ids = list(used["vid"])
    ann = pandas.read_csv(path.join(root_path, "text_annotations/a2d_annotation.txt"))
    assert len(ann) == 6655, "error: a2d_annotation.txt is missing samples"
    ann = ann[ann.video_id.isin(used_ids)]
    ann = ann[ann["instance_id"] != "1 (copy)"]  # a known annotation mistake
    mask_dir = path.join(root_path, "text_annotations/a2d_annotation_with_instances")
    out = []
    for video_id, instance_id, text in list(ann.to_records(index=False)):
        instance_id = int(instance_id)
        for p in sorted(glob(path.join(mask_dir, video_id, "*.h5"))):
            with h5py.File(p, "r") as f:
                if instance_id in list(f["instance"]):
                    frame_idx = int(path.basename(p).split(".")[0])
                    out.append((text.lower(), video_id, frame_idx, instance_id))
    try:
        with open(cache, "w") as f:
            json.dump(out, f, indent=2)
    except OSError:  # a read-only dataset tree: the index is rebuilt next time
        pass
    return out


class A2DSentencesDataset:
    def __init__(self, subset_type: str = "train", dataset_path: str = "data/a2d_sentences",
                 window_size: int = 8, transforms_kwargs: Optional[Dict] = None,
                 cache_dir: Optional[str] = None, force_rebuild_metadata: bool = False):
        assert subset_type in ("train", "test")
        self.subset_type = subset_type
        self.window_size = window_size
        self.videos_dir = path.join(dataset_path, "Release/clips320H")
        self.mask_annotations_dir = path.join(
            dataset_path, "text_annotations/a2d_annotation_with_instances")
        self.text_annotations = build_text_annotations(
            dataset_path, subset_type, cache_dir, force_rebuild=force_rebuild_metadata)
        self.transforms = VideoTransforms(subset_type, **(transforms_kwargs or {}))
        self.seed = int((transforms_kwargs or {}).get("seed") or 0)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Advance the per-sample augmentation streams (transforms.stable_rng);
        called by the training batch iterator."""
        self._epoch = epoch

    def __len__(self):
        return len(self.text_annotations)

    def __getitem__(self, idx: int) -> Dict:
        import h5py

        text, video_id, frame_idx, instance_id = self.text_annotations[idx]
        text = " ".join(text.lower().split())
        video_path = path.join(self.videos_dir, f"{video_id}.mp4")
        # the window centred on the (1-indexed) annotated frame
        start = frame_idx - 1 - self.window_size // 2
        end = frame_idx - 1 + (self.window_size + 1) // 2
        n_frames = video_frame_count(video_path)
        video = np.empty(0)
        offset = 0
        if n_frames > 0:  # decode only the clamped window, not the whole clip
            lo = min(max(start, 0), n_frames - 1)
            hi = min(max(end, lo + 1), n_frames)
            video = read_video_frames_cv2(video_path, lo, hi)
            offset = lo
        if video.size == 0:
            # the container's frame count can overestimate what decodes, so the
            # clamped window may start past the real end: decode the whole
            # video as the reference does, which clamps to what decodes
            video = read_video_frames_cv2(video_path)
            offset = 0
            assert video.size, f"no decodable frames in {video_path}"
        frames = [video[min(max(i - offset, 0), len(video) - 1)] for i in range(start, end)]

        with h5py.File(path.join(self.mask_annotations_dir, video_id,
                                 f"{frame_idx:05d}.h5"), "r") as f:
            instances = list(f["instance"])
            inst_pos = instances.index(instance_id)
            inst_masks = np.array(f["reMask"])
        if len(instances) == 1:
            inst_masks = inst_masks[np.newaxis]
        inst_masks = inst_masks.transpose(0, 2, 1)  # h5 stores (W, H)
        mask = inst_masks[inst_pos].astype(np.uint8)

        h, w = mask.shape
        if mask.any():
            ys, xs = np.nonzero(mask)
            box = np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
        else:
            box = np.zeros(4, np.float32)
        frames, masks, boxes, text = self.transforms(
            frames, mask[None, None], box[None, None], text,
            rng=stable_rng(self.seed, self._epoch, idx))
        return {
            "frames": normalize_frames(np.stack(frames)),
            "text": text,
            "masks": masks,
            "boxes": boxes,
            "labels": np.zeros(1, np.int32),
            "is_visible": np.array([[bool(mask.any())]]),
            "referred_instance_idx": 0,
            "valid_frame_idx": self.window_size // 2,
            "image_id": get_image_id(video_id, frame_idx, instance_id),
            "orig_size": (h, w),
        }
