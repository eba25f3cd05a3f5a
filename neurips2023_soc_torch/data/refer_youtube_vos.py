"""Ref-YouTube-VOS dataset (reference
datasets/refer_youtube_vos/refer_youtube_vos_dataset.py; the port's copy of
neurips2023_soc_tpu/data/refer_youtube_vos.py, numpy and PIL).

Train: window-size-W clip windows per expression, skipping windows where the
referred object never appears; per-frame masks/boxes/visibility + the 65-way
category label. Valid: full-length videos with metadata, 202-video filter.
Sample dicts feed data/collate.py (fixed-shape batches).
"""
from __future__ import annotations

import json
from glob import glob
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .collate import frames_to_uint8, normalize_frames
from .transforms import VideoTransforms, stable_rng

YTVOS_CATEGORIES = {
    'airplane': 0, 'ape': 1, 'bear': 2, 'bike': 3, 'bird': 4, 'boat': 5,
    'bucket': 6, 'bus': 7, 'camel': 8, 'cat': 9, 'cow': 10, 'crocodile': 11,
    'deer': 12, 'dog': 13, 'dolphin': 14, 'duck': 15, 'eagle': 16,
    'earless_seal': 17, 'elephant': 18, 'fish': 19, 'fox': 20, 'frisbee': 21,
    'frog': 22, 'giant_panda': 23, 'giraffe': 24, 'hand': 25, 'hat': 26,
    'hedgehog': 27, 'horse': 28, 'knife': 29, 'leopard': 30, 'lion': 31,
    'lizard': 32, 'monkey': 33, 'motorbike': 34, 'mouse': 35, 'others': 36,
    'owl': 37, 'paddle': 38, 'parachute': 39, 'parrot': 40, 'penguin': 41,
    'person': 42, 'plant': 43, 'rabbit': 44, 'raccoon': 45, 'sedan': 46,
    'shark': 47, 'sheep': 48, 'sign': 49, 'skateboard': 50, 'snail': 51,
    'snake': 52, 'snowboard': 53, 'squirrel': 54, 'surfboard': 55,
    'tennis_racket': 56, 'tiger': 57, 'toilet': 58, 'train': 59, 'truck': 60,
    'turtle': 61, 'umbrella': 62, 'whale': 63, 'zebra': 64,
}


def _bounding_box(mask: np.ndarray) -> Tuple[int, int, int, int]:
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return int(cmin), int(rmin), int(cmax), int(rmax)  # x1, y1, x2, y2


class ReferYouTubeVOSDataset:
    def __init__(
        self,
        subset_type: str = "train",
        dataset_path: str = "data/refer_youtube_vos",
        window_size: int = 8,
        check_counts: bool = True,
        transforms_kwargs: Optional[Dict] = None,
        metadata_dir: Optional[str] = None,
    ):
        if subset_type not in ("train", "test"):
            raise ValueError(f"subset_type {subset_type!r}: expected 'train' or 'test'")
        if subset_type == "test":
            subset_type = "valid"
        self.subset_type = subset_type
        self.window_size = window_size
        self.dataset_path = dataset_path
        self.videos_dir = path.join(dataset_path, subset_type, "JPEGImages")
        if check_counts:
            expected = {"train": 3471, "valid": 202}[subset_type]
            n = len(glob(path.join(self.videos_dir, "*")))
            if n != expected:
                raise ValueError(f"{subset_type} subset has {n} videos, expected {expected}")
        self.mask_annotations_dir = (
            path.join(dataset_path, subset_type, "Annotations")
            if subset_type == "train" else None
        )
        self.metadata_dir = metadata_dir or dataset_path
        self.samples_list = self._generate_metadata()
        self.transforms = VideoTransforms(subset_type, **(transforms_kwargs or {}))
        self.seed = int((transforms_kwargs or {}).get("seed") or 0)
        self._epoch = 0
        self._meta_by_video = None

    def set_epoch(self, epoch: int):
        """Advance the per-sample augmentation streams (see
        transforms.stable_rng); called by the training batch iterator."""
        self._epoch = epoch

    # ---------------- metadata ----------------
    def _generate_metadata(self) -> List[Tuple]:
        cache = path.join(
            self.metadata_dir,
            f"{self.subset_type}_samples_metadata_win_{self.window_size}.json",
        )
        if path.exists(cache):
            with open(cache) as f:
                return [tuple(s) for s in json.load(f)]
        meta_path = path.join(
            self.dataset_path, "meta_expressions", self.subset_type,
            "meta_expressions.json",
        )
        with open(meta_path) as f:
            by_video = json.load(f)["videos"]
        samples: List[Tuple] = []
        if self.subset_type == "train":
            for vid_id, vid_data in by_video.items():
                samples.extend(self._train_video_samples(vid_id, vid_data))
        else:
            # the competition 'valid' expressions file includes test videos;
            # filter them out using the test expressions file
            test_meta = path.join(
                self.dataset_path, "meta_expressions", "test",
                "meta_expressions.json",
            )
            with open(test_meta) as f:
                test_videos = set(json.load(f)["videos"].keys())
            by_video = {k: v for k, v in by_video.items() if k not in test_videos}
            for vid_id, data in by_video.items():
                frames = sorted(data["frames"])
                for exp_id, exp in data["expressions"].items():
                    exp = dict(exp, exp_id=exp_id)
                    samples.append((vid_id, frames, exp))
        try:
            with open(cache, "w") as f:
                json.dump(samples, f)
        except OSError:
            pass
        return samples

    def _train_video_samples(self, vid_id: str, vid_data: Dict) -> List[Tuple]:
        frames = sorted(vid_data["frames"])
        W = self.window_size
        windows = [frames[i : i + W] for i in range(0, len(frames), W)]
        if len(windows[-1]) < W:
            if len(frames) >= W:
                windows[-1] = frames[-W:]
            else:
                windows[-1] = windows[-1] + (W - len(windows[-1])) * [windows[-1][-1]]
        out = []
        for exp_id, exp in vid_data["expressions"].items():
            exp = dict(exp, exp_id=exp_id)
            for window in windows:
                # keep only windows where the referred object appears
                obj_present = False
                for idx in window:
                    p = path.join(self.mask_annotations_dir, vid_id, f"{idx}.png")
                    if int(exp["obj_id"]) in np.unique(np.array(Image.open(p))):
                        obj_present = True
                        break
                if obj_present:
                    out.append((vid_id, window, exp))
        return out

    def __len__(self):
        return len(self.samples_list)

    # ------------- multi-expression inference accessors -------------
    def get_text(self, idx: int) -> str:
        """The expression text exactly as __getitem__ yields it (test
        transforms never alter text), without decoding frames."""
        return " ".join(self.samples_list[idx][2]["exp"].lower().split())

    def exp_id(self, idx: int) -> str:
        return self.samples_list[idx][2].get("exp_id")

    def video_groups(self) -> Dict[Tuple[str, Tuple], List[int]]:
        """Sample indices grouped by (video_id, frame_window) — one video can
        map to several groups when frame windows differ. Every group shares
        decoded frames, so inference can run the text-independent backbone
        once per group (InferenceEngine.infer_video_multi). Callers consume
        .values(); the keys exist for debugging."""
        groups: Dict = {}
        for i, (vid_id, frame_indices, _) in enumerate(self.samples_list):
            groups.setdefault((vid_id, tuple(frame_indices)), []).append(i)
        return groups

    # ---------------- loading ----------------
    def _category_of(self, vid_id: str, obj_id: str) -> int:
        if self._meta_by_video is None:
            with open(path.join(self.dataset_path, self.subset_type, "meta.json")) as f:
                self._meta_by_video = json.load(f)["videos"]
        cat = self._meta_by_video[vid_id]["objects"][obj_id]["category"]
        return YTVOS_CATEGORIES[cat]

    def __getitem__(self, idx: int) -> Dict:
        vid_id, frame_indices, exp = self.samples_list[idx]
        text = self.get_text(idx)  # train transforms may still alter it below
        frames = [
            np.asarray(
                Image.open(path.join(self.videos_dir, vid_id, f"{i}.jpg")).convert("RGB"),
                np.float32,
            ) / 255.0
            for i in frame_indices
        ]
        orig_size = frames[0].shape[:2]

        if self.subset_type == "train":
            ann = [
                np.array(Image.open(
                    path.join(self.mask_annotations_dir, vid_id, f"{i}.png")))
                for i in frame_indices
            ]
            obj_id = int(exp["obj_id"])
            T = len(frames)
            h, w = orig_size
            masks = np.zeros((T, 1, h, w), np.uint8)
            boxes = np.zeros((T, 1, 4), np.float32)
            visible = np.zeros((T, 1), bool)
            for t, m in enumerate(ann):
                om = (m == obj_id).astype(np.uint8)
                masks[t, 0] = om
                if om.any():
                    x1, y1, x2, y2 = _bounding_box(om)
                    boxes[t, 0] = (x1, y1, x2, y2)
                    visible[t, 0] = True
            frames, masks, boxes, text = self.transforms(
                frames, masks, boxes, text,
                rng=stable_rng(self.seed, self._epoch, idx))
            return {
                "frames": normalize_frames(np.stack(frames)),
                "text": text,
                "masks": masks,
                "boxes": boxes,
                "labels": np.array([self._category_of(vid_id, exp["obj_id"])],
                                   np.int32),
                "is_visible": visible,
                "referred_instance_idx": 0,
            }
        # validation: no annotations, attach metadata for postprocessing.
        # Frames ship as RAW uint8 — InferenceEngine normalizes on device
        # (4x smaller host->device transfer, no numpy normalize pass)
        frames, _, _, text = self.transforms(frames, None, None, text)
        return {
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
