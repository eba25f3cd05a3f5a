"""Size and clip-length buckets and host-side padding (a frozen copy of the
port's utils/padded.py). A clip is padded to a bucketed (T, H, W) so the engine
sees a few fixed shapes."""
from __future__ import annotations

from typing import Sequence, Tuple

# the training resolutions' spatial buckets (360/640 Ref-YTVOS, 320/576 A2D),
# multiples of 64 so every level of the stride-4..64 pyramid is integral
DEFAULT_SIZE_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 448), (320, 576), (384, 640), (448, 768), (512, 896))
DEFAULT_TIME_BUCKETS: Tuple[int, ...] = (1, 8, 16, 32, 64)


def train_size_buckets(short_size: int, max_size: int) -> Tuple[Tuple[int, int], ...]:
    """The eval buckets (short x max and max x short) plus the (max, max) square: a batch that mixes
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
