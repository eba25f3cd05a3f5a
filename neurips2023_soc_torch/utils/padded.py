"""Size and clip-length buckets and host-side padding (the port's copy of
neurips2023_soc_tpu/utils/padded.py). A clip is padded to a bucketed
(T, H, W) so the engine sees a few fixed shapes."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# the training resolutions' spatial buckets (360/640 Ref-YTVOS, 320/576 A2D),
# multiples of 64 so every level of the stride-4..64 pyramid is integral
DEFAULT_SIZE_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 448), (320, 576), (384, 640), (448, 768), (512, 896))
DEFAULT_TIME_BUCKETS: Tuple[int, ...] = (1, 8, 16, 32, 64)


def eval_size_buckets(short_size: int, max_size: int) -> Tuple[Tuple[int, int], ...]:
    """Size buckets covering both orientations of eval-resized frames."""
    if short_size == max_size:
        return ((short_size, max_size),)
    return ((short_size, max_size), (max_size, short_size))


def train_size_buckets(short_size: int, max_size: int) -> Tuple[Tuple[int, int], ...]:
    """eval_size_buckets plus the (max, max) square: a batch that mixes
    portrait and landscape samples pads to the per-dimension maximum over the
    batch, as the reference's NestedTensor does (misc.py:143-160), and only
    the square bucket holds that."""
    if short_size == max_size:
        return ((short_size, max_size),)
    return ((short_size, max_size), (max_size, short_size), (max_size, max_size))


def pick_size_bucket(h: int, w: int,
                     buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    raise ValueError(
        f"frame size ({h}, {w}) exceeds every size bucket {tuple(buckets)}; "
        "resize the frames first or pass larger size_buckets")


def pick_time_bucket(t: int, buckets: Sequence[int]) -> int:
    for bt in buckets:
        if t <= bt:
            return bt
    raise ValueError(
        f"clip length {t} exceeds every time bucket {tuple(buckets)}; "
        "chunk the video (InferenceEngine does) or pass larger time_buckets")


def batch_videos(videos: List[List[np.ndarray]],
                 size_buckets: Sequence[Tuple[int, int]] = DEFAULT_SIZE_BUCKETS,
                 time_buckets: Sequence[int] = DEFAULT_TIME_BUCKETS, dtype=np.float32):
    """A list of videos (each a list of (H, W, 3) frames) -> a zero-padded
    (T, B, H, W, 3) pixel array in the smallest time and size buckets that
    hold them, and the (T, B, H, W) pad mask (True on padding)."""
    T = pick_time_bucket(max(len(v) for v in videos), time_buckets)
    H, W = pick_size_bucket(max(f.shape[0] for v in videos for f in v),
                            max(f.shape[1] for v in videos for f in v), size_buckets)
    pixels = np.zeros((T, len(videos), H, W, 3), dtype=dtype)
    pad_mask = np.ones((T, len(videos), H, W), dtype=bool)
    for b, video in enumerate(videos):
        for t, frame in enumerate(video):
            fh, fw = frame.shape[:2]
            pixels[t, b, :fh, :fw] = frame
            pad_mask[t, b, :fh, :fw] = False
    return pixels, pad_mask


def pad_instances(arrays: List[np.ndarray], max_n: int,
                  pad_value=0) -> Tuple[np.ndarray, np.ndarray]:
    """A ragged list of per-sample instance arrays -> (B, max_n, ...) padded
    with `pad_value` (instances beyond max_n dropped) and the (B, max_n)
    validity mask."""
    trailing = arrays[0].shape[1:] if len(arrays) and arrays[0].ndim > 1 else ()
    out = np.full((len(arrays), max_n) + trailing, pad_value, dtype=arrays[0].dtype)
    valid = np.zeros((len(arrays), max_n), dtype=bool)
    for b, a in enumerate(arrays):
        n = min(len(a), max_n)
        out[b, :n] = a[:n]
        valid[b, :n] = True
    return out, valid
