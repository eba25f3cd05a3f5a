"""Size and clip-length buckets (the port's copy of the bucket helpers in
neurips2023_soc_tpu/utils/padded.py). A clip is padded to a bucketed
(T, H, W) so the engine sees a few fixed shapes."""
from __future__ import annotations

from typing import Sequence, Tuple


def eval_size_buckets(short_size: int, max_size: int) -> Tuple[Tuple[int, int], ...]:
    """Size buckets covering both orientations of eval-resized frames."""
    if short_size == max_size:
        return ((short_size, max_size),)
    return ((short_size, max_size), (max_size, short_size))


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
