"""Host-side video transforms (reference datasets/transforms.py, numpy with
cv2 when it is installed, else PIL): the port's copy of
neurips2023_soc_tpu/data/transforms.py.

These run in the input pipeline before batching; everything on the device is
in models/. Frames are float32 (H, W, 3) in [0,1] after ToTensor-equivalent;
masks uint8 (N, H, W); boxes float32 (N, 4) xyxy absolute pixels.
"""
from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def stable_rng(seed: int, epoch: int, idx: int) -> random.Random:
    """A fresh per-sample RNG keyed on (seed, epoch, idx) — thread-safe under
    multi-worker loading: each sample's
    augmentation draws are identical at ANY worker count, unlike a shared
    dataset-level stream whose interleaving is scheduler-dependent."""
    mix = (int(seed) * 1_000_003 + int(epoch)) * 1_000_003 + int(idx)
    return random.Random(mix & 0x7FFFFFFFFFFFFFFF)


def size_with_aspect_ratio(h: int, w: int, size: int,
                           max_size: Optional[int]) -> Tuple[int, int]:
    """Shorter-side resize target (reference transforms.py:186-205)."""
    if max_size is not None:
        min_orig, max_orig = float(min(w, h)), float(max(w, h))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        oh, ow = h, w
    elif w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    if max_size is not None:
        # the rounded size adjustment can overshoot max_size by a few pixels
        # at extreme aspect ratios (reference transforms.py:186-205 has the
        # same arithmetic; its dynamic NestedTensor padding absorbs the
        # overshoot, misc.py:143-160, while static size buckets cannot) —
        # cap both dims so resized frames always fit the derived buckets
        oh, ow = min(oh, max_size), min(ow, max_size)
    return oh, ow


def resize_frame(frame: np.ndarray, oh: int, ow: int) -> np.ndarray:
    if cv2 is not None:
        return cv2.resize(frame, (ow, oh), interpolation=cv2.INTER_LINEAR)
    from PIL import Image

    return np.asarray(
        Image.fromarray((frame * 255).astype(np.uint8)).resize((ow, oh))
    ).astype(np.float32) / 255.0


def resize_mask(mask: np.ndarray, oh: int, ow: int) -> np.ndarray:
    if cv2 is not None:
        return cv2.resize(mask, (ow, oh), interpolation=cv2.INTER_NEAREST)
    from PIL import Image

    return np.asarray(Image.fromarray(mask).resize((ow, oh), resample=0))


def hflip_sample(frames, masks, boxes, text):
    """Horizontal flip + left/right word swap (reference
    refer_youtube_vos_dataset.py:254-262)."""
    frames = [f[:, ::-1].copy() for f in frames]
    masks = masks[..., ::-1].copy()
    w = frames[0].shape[1]
    if boxes is not None and boxes.size:
        x0 = boxes[..., 0].copy()
        x2 = boxes[..., 2].copy()
        boxes[..., 0] = w - x2
        boxes[..., 2] = w - x0
    text = text.replace("left", "@").replace("right", "left").replace("@", "right")
    return frames, masks, boxes, text


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Vectorized RGB->HSV, H in degrees [0,360), S in [0,1], V = max channel.

    Matches cv2.cvtColor(float32, COLOR_BGR2HSV) semantics up to the channel
    ordering quirk the reference inherits (it feeds RGB arrays through a
    BGR-labelled conversion — the conversion itself is order-symmetric for
    S/V and only relabels hue, which is irrelevant for random jitter)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    diff = mx - mn
    safe = np.where(diff > 0, diff, 1.0)
    h = np.zeros_like(mx)
    h = np.where(mx == r, (g - b) / safe % 6.0, h)
    h = np.where((mx == g) & (mx != r), (b - r) / safe + 2.0, h)
    h = np.where((mx == b) & (mx != r) & (mx != g), (r - g) / safe + 4.0, h)
    h = np.where(diff > 0, h * 60.0, 0.0)
    s = np.where(mx > 0, diff / np.where(mx > 0, mx, 1.0), 0.0)
    return np.stack([h, s, mx], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Inverse of rgb_to_hsv (H degrees, S/V as above)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = (h % 360.0) / 60.0
    c = v * s
    x = c * (1.0 - np.abs(h6 % 2.0 - 1.0))
    m = v - c
    z = np.zeros_like(c)
    i = np.floor(h6).astype(np.int32) % 6
    rgb_by_sextant = np.stack([
        np.stack([c, x, z], -1), np.stack([x, c, z], -1),
        np.stack([z, c, x], -1), np.stack([z, x, c], -1),
        np.stack([x, z, c], -1), np.stack([c, z, x], -1),
    ])  # (6, ..., 3)
    rgb = np.take_along_axis(
        rgb_by_sextant, i[None, ..., None].repeat(3, -1), axis=0)[0]
    return rgb + m[..., None]


# RandomLightingNoise channel permutations (reference transforms.py:114-126).
_LIGHTING_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                   (2, 1, 0))


def photometric_distort(frames: List[np.ndarray], rng: random.Random):
    """Per-frame photometric distortion (reference transforms.py:17-43
    PhotometricDistort): each frame independently gets brightness jitter,
    contrast either before or after the HSV block (never both), saturation
    and hue jitter in HSV space, and a random channel permutation
    (RandomLightingNoise). The reference draws fresh randomness per frame
    of the clip (its __call__ loops over frames), so no clip consistency."""
    out = []
    for f in frames:
        img = f.astype(np.float32).copy()
        # RandomBrightness(delta=32) on 0..255 scale (transforms.py:79-88)
        if rng.random() < 0.5:
            img += rng.uniform(-32.0 / 255.0, 32.0 / 255.0)
        # pd[:-1] (contrast first) vs pd[1:] (contrast last), transforms.py:35-39
        contrast_first = rng.random() < 0.5
        if contrast_first and rng.random() < 0.5:
            img *= rng.uniform(0.5, 1.5)
        hsv = rgb_to_hsv(np.clip(img, 0.0, 1.0))
        # RandomSaturation (transforms.py:90-100)
        if rng.random() < 0.5:
            hsv[..., 1] *= rng.uniform(0.5, 1.5)
        # RandomHue(delta=18) with wraparound (transforms.py:102-112)
        if rng.random() < 0.5:
            h = hsv[..., 0] + rng.uniform(-18.0, 18.0)
            h = np.where(h > 360.0, h - 360.0, h)
            h = np.where(h < 0.0, h + 360.0, h)
            hsv[..., 0] = h
        # NO saturation clamp before converting back: the reference converts
        # with S>1 (cv2 computes c=v*s, m=v-c<0, negative channels).
        # DELIBERATE DEVIATION (COMPONENTS.md bug register): the reference
        # then casts with numpy astype(uint8), which WRAPS modulo 256 on
        # out-of-range values (a latent color-corruption bug); the clips here
        # (to [0,1] before rgb_to_hsv and at the end) saturate instead.
        img = hsv_to_rgb(hsv)
        if not contrast_first and rng.random() < 0.5:
            img *= rng.uniform(0.5, 1.5)
        # RandomLightingNoise channel swap (transforms.py:114-126)
        if rng.random() < 0.5:
            perm = _LIGHTING_PERMS[rng.randrange(len(_LIGHTING_PERMS))]
            img = img[..., perm]
        out.append(np.clip(img, 0.0, 1.0).astype(np.float32))
    return out


class VideoTransforms:
    """A2dSentencesTransforms equivalent (reference
    refer_youtube_vos_dataset.py:240-270): optional hflip + photometric
    distort (train), deterministic shorter-side resize, normalize happens at
    collate time."""

    def __init__(self, subset_type: str, horizontal_flip_augmentations=True,
                 resize_and_crop_augmentations=True, random_color=False,
                 train_short_size=360, train_max_size=640,
                 eval_short_size=360, eval_max_size=640, seed=None, **kwargs):
        self.train = subset_type == "train"
        self.h_flip = self.train and horizontal_flip_augmentations
        self.random_color = self.train and random_color
        self.do_resize = resize_and_crop_augmentations
        self.size = train_short_size if self.train else eval_short_size
        self.max_size = train_max_size if self.train else eval_max_size
        self.rng = random.Random(seed)

    def __call__(self, frames: List[np.ndarray], masks: Optional[np.ndarray],
                 boxes: Optional[np.ndarray], text: str,
                 rng: Optional[random.Random] = None):
        """frames: list of (H, W, 3) float32 [0,1]; masks (T, N, H, W) uint8;
        boxes (T, N, 4) xyxy absolute. Returns same structures resized.

        rng: per-sample stream (see stable_rng) — REQUIRED for deterministic
        augmentations under multi-worker loading; the shared fallback stream
        is only safe single-threaded."""
        rng = rng if rng is not None else self.rng
        if self.h_flip and rng.random() > 0.5:
            frames, masks, boxes, text = hflip_sample(frames, masks, boxes, text)
        if self.random_color and rng.random() > 0.5:
            frames = photometric_distort(frames, rng)
        if self.do_resize:
            h, w = frames[0].shape[:2]
            oh, ow = size_with_aspect_ratio(h, w, self.size, self.max_size)
            if (oh, ow) != (h, w):
                sy, sx = oh / h, ow / w
                frames = [resize_frame(f, oh, ow) for f in frames]
                if masks is not None and masks.size:
                    T, N = masks.shape[:2]
                    masks = np.stack([
                        np.stack([resize_mask(masks[t, n], oh, ow)
                                  for n in range(N)])
                        for t in range(T)
                    ])
                if boxes is not None and boxes.size:
                    boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        return frames, masks, boxes, text
