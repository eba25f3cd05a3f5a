"""RefCOCO/+/g image-as-clip datasets (the port's copy of
neurips2023_soc_tpu/data/coco_ref.py; reference datasets/coco/ref2seq.py and
image_to_seq_augmenter.py).

For pretraining each image is one frame (T = 1). For joint training it
becomes an 8-frame pseudo-video: per frame a random perspective and affine
warp (with a brightness shift and, at random, motion blur) of the image and
its referred-instance mask (cv2 in place of imgaug); the frames are shuffled
and per-frame targets carry visibility. A training sample whose referred
instance is never visible is drawn again. COCO polygons are rasterized with
PIL. cv2 and PIL are imported by the functions that use them.
"""
from __future__ import annotations

import json
import random
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .collate import normalize_frames
from .transforms import VideoTransforms, stable_rng


def polygons_to_mask(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    mask = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(mask)
    for poly in polygons:
        if len(poly) >= 6:
            draw.polygon(list(map(float, poly)), outline=1, fill=1)
    return np.asarray(mask, np.uint8)


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    from ..evaluation.rle import decode

    rle = dict(seg)
    rle.setdefault("size", [h, w])
    return decode(rle)


class ImageToSeqAugmenter:
    """cv2 counterpart of the reference's imgaug pipeline
    (image_to_seq_augmenter.py:19-52): brightness add, perspective 0.12,
    affine translate +-15 % and rotate +-20 degrees, motion blur of kernel 7 or 9
    with p = 0.5. Every draw comes from `rng`, in a fixed order."""

    def __init__(self, perspective=True, affine=True, motion_blur=True,
                 brightness_range=(-50, 50), perspective_magnitude=0.12,
                 translate_range=0.15, rotation_range=(-20, 20),
                 motion_blur_kernel_sizes=(7, 9), motion_blur_prob=0.5,
                 rng: Optional[random.Random] = None):
        self.perspective = perspective
        self.affine = affine
        self.motion_blur = motion_blur
        self.brightness_range = brightness_range
        self.perspective_magnitude = perspective_magnitude
        self.translate_range = translate_range
        self.rotation_range = rotation_range
        self.motion_blur_kernel_sizes = motion_blur_kernel_sizes
        self.motion_blur_prob = motion_blur_prob
        self.rng = rng or random.Random()

    def _transform_matrix(self, h: int, w: int) -> np.ndarray:
        import cv2

        M = np.eye(3, dtype=np.float64)
        if self.perspective:
            mag = self.perspective_magnitude
            src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
            jitter = np.float32([[self.rng.gauss(0, mag) * w, self.rng.gauss(0, mag) * h]
                                 for _ in range(4)])
            M = cv2.getPerspectiveTransform(src, src + jitter) @ M
        if self.affine:
            angle = self.rng.uniform(*self.rotation_range)
            tx = self.rng.uniform(-self.translate_range, self.translate_range) * w
            ty = self.rng.uniform(-self.translate_range, self.translate_range) * h
            A = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
            A[0, 2] += tx
            A[1, 2] += ty
            M = np.vstack([A, [0, 0, 1]]) @ M
        return M

    def __call__(self, image: np.ndarray, masks: List[np.ndarray]):
        """image uint8 (H, W, 3); masks a list of (H, W) uint8. Returns the
        warped (image, masks), one geometry for all."""
        import cv2

        h, w = image.shape[:2]
        img = np.clip(image.astype(np.float32) + self.rng.uniform(*self.brightness_range),
                      0, 255)
        M = self._transform_matrix(h, w).astype(np.float32)
        warped = cv2.warpPerspective(img.astype(np.uint8), M, (w, h), flags=cv2.INTER_LINEAR)
        warped_masks = [cv2.warpPerspective(m.astype(np.uint8), M, (w, h),
                                            flags=cv2.INTER_NEAREST) for m in masks]
        if self.motion_blur and self.rng.random() < self.motion_blur_prob:
            k = self.rng.choice(self.motion_blur_kernel_sizes)
            kernel = np.zeros((k, k), np.float32)
            angle = self.rng.uniform(0, 180)
            c = (k - 1) / 2
            for i in range(k):  # a line through the centre
                x = int(round(c + (i - c) * np.cos(np.radians(angle))))
                y = int(round(c + (i - c) * np.sin(np.radians(angle))))
                if 0 <= x < k and 0 <= y < k:
                    kernel[y, x] = 1
            kernel /= max(kernel.sum(), 1)
            warped = cv2.filter2D(warped, -1, kernel)
        return warped, warped_masks


class RefCOCOClipDataset:
    """An MDETR-style refexp COCO json as samples of one frame (`as_clip`
    False, pretraining) or of `num_frames`-frame pseudo-videos (True, joint
    training)."""

    def __init__(self, ann_file: str, img_folder: str, num_frames: int = 8,
                 subset_type: str = "train", transforms_kwargs: Optional[Dict] = None,
                 seed: int = 0, as_clip: bool = True):
        with open(ann_file) as f:
            coco = json.load(f)
        self.imgs = {im["id"]: im for im in coco["images"]}
        anns_by_img: Dict[int, List[Dict]] = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.items = [(iid, anns_by_img[iid]) for iid in self.imgs if anns_by_img.get(iid)]
        self.img_folder = img_folder
        self.num_frames = num_frames if as_clip else 1
        self.as_clip = as_clip
        self.train = subset_type == "train"
        self.seed = seed
        self._epoch = 0
        self.transforms = VideoTransforms(subset_type, **(transforms_kwargs or {}))

    def set_epoch(self, epoch: int):
        """Advance the per-sample augmentation streams (transforms.stable_rng);
        called by the training batch iterator."""
        self._epoch = epoch

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        # a per-(epoch, idx) stream: the same draws at any worker count
        rng = stable_rng(self.seed, self._epoch, idx)
        if not self.train:  # evaluation visits every image once, unchanged
            return self._load(idx, rng)
        for _ in range(20):  # draw again while the referred instance is never visible
            sample = self._load(idx, rng)
            if sample["is_visible"].any():
                return sample
            idx = rng.randint(0, len(self) - 1)
        return sample

    def _load(self, idx: int, rng: random.Random) -> Dict:
        from PIL import Image

        image_id, anns = self.items[idx]
        im_info = self.imgs[image_id]
        caption = im_info.get("caption", "")
        img = np.asarray(Image.open(path.join(self.img_folder, im_info["file_name"]))
                         .convert("RGB"))
        h, w = img.shape[:2]
        mask = ann_to_mask(anns[0], h, w)  # one referred instance per sample

        augmenter = ImageToSeqAugmenter(rng=rng)
        seq_imgs, seq_masks = [img], [mask]
        for _ in range(self.num_frames - 1):
            wi, wm = augmenter(img, [mask])
            seq_imgs.append(wi)
            seq_masks.append(wm[0])
        if self.as_clip:
            perm = list(range(self.num_frames))
            rng.shuffle(perm)
            seq_imgs = [seq_imgs[i] for i in perm]
            seq_masks = [seq_masks[i] for i in perm]

        T = self.num_frames
        masks = np.stack(seq_masks)[:, None]  # (T, 1, h, w)
        boxes = np.zeros((T, 1, 4), np.float32)
        visible = np.zeros((T, 1), bool)
        for t in range(T):
            m = masks[t, 0]
            if m.any():
                ys, xs = np.nonzero(m)
                boxes[t, 0] = (xs.min(), ys.min(), xs.max(), ys.max())
                visible[t, 0] = True
        frames = [f.astype(np.float32) / 255.0 for f in seq_imgs]
        text = " ".join(caption.lower().split())
        frames, masks, boxes, text = self.transforms(frames, masks, boxes, text, rng=rng)
        return {
            "frames": normalize_frames(np.stack(frames)),
            "text": text,
            "masks": masks,
            "boxes": boxes,
            "labels": np.zeros(1, np.int32),
            "is_visible": visible,
            "referred_instance_idx": 0,
            "image_id": image_id,
            "orig_size": (h, w),
        }


REFCOCO_NAMES = ("refcoco", "refcoco+", "refcocog")


def find_refcoco_ann_file(name: str, subset: str, ann_root: str,
                          img_folder: str) -> Optional[str]:
    """The annotation json of a RefCOCO split: the reference's layout
    `{ann_root}/{name}/instances_{name}_{subset}.json` (reference
    pretrainer.py:405-410), then the MDETR-style
    `{img_folder}/annotations/{instances|finetune}_{name}_{subset}.json`."""
    candidates = [
        path.join(ann_root, name, f"instances_{name}_{subset}.json"),
        path.join(img_folder, "annotations", f"instances_{name}_{subset}.json"),
        path.join(img_folder, "annotations", f"finetune_{name}_{subset}.json"),
    ]
    for c in candidates:
        if path.exists(c):
            return c
    return None


def build_refcoco_val_datasets(config) -> List[Tuple[str, RefCOCOClipDataset]]:
    """Single-frame (T = 1) validation datasets of the three RefCOCO splits
    (reference refercoco.py:12-50 and pretrainer.py:87-108): [(name,
    dataset)] for every split whose val json exists."""
    tk = dict(horizontal_flip_augmentations=False, resize_and_crop_augmentations=True,
              random_color=False, eval_short_size=config.eval_short_size,
              eval_max_size=config.eval_max_size)
    out = []
    for name in REFCOCO_NAMES:
        ann = find_refcoco_ann_file(name, "val", config.get("ann_file", ""), config.img_folder)
        if ann is not None:
            out.append((name, RefCOCOClipDataset(
                ann, path.join(config.img_folder, "train2014"), subset_type="valid",
                transforms_kwargs=tk, as_clip=False)))
    return out


class ConcatClipDataset:
    """ConcatDataset for joint RefCOCO-as-clip + Ref-YouTube-VOS training
    (reference datasets/concat_dataset.py:14-31)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __getitem__(self, idx: int):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


def build_refcoco_gt(dataset):
    """COCO-format GT straight from the val json annotations, in original
    image coordinates (predictions are mapped back to the original size by
    the postprocessor). `dataset` has `items` [(image_id, [ann, ...])] and
    `imgs` {image_id: {height, width}}. Returns (gt_annotations,
    gt_boxes_by_img) for evaluators.evaluate_coco_pretrain_batches."""
    from ..evaluation.rle import encode as rle_encode

    gt_annotations: List[Dict] = []
    gt_boxes_by_img: Dict = {}
    for image_id, anns in dataset.items:
        im = dataset.imgs[image_id]
        h, w = im["height"], im["width"]
        ann = anns[0]  # one referred instance per image in refexp jsons
        mask = ann_to_mask(ann, h, w)
        gt_annotations.append({
            "image_id": image_id,
            "segmentation": rle_encode(mask),
            "iscrowd": int(ann.get("iscrowd", 0)),
            "area": float(ann.get("area", int(mask.sum()))),
        })
        x, y, bw, bh = ann["bbox"]
        gt_boxes_by_img[image_id] = np.array([[x, y, x + bw, y + bh]], np.float32)
    return gt_annotations, gt_boxes_by_img
