"""Videos with referring expressions for the engine, from the seed.

The mix file fixes the pool, one (frames, expressions) pair per video, and
the cycle the loop hands it out in: a permutation drawn from the mix's own
`cycle_seed`. A run's seed picks where in that cycle the loop starts, and the
pixels and words of every video. So every seed sees the same videos, each
behind the same predecessor, and a video's latency, which takes in the
engine's dispatch of the video after it, draws on the same pairs whatever
the seed. The loop goes round and round; each use marks the first pixel of
the first frame with the use's number, so no two videos the engine sees are
equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Video:
    frames: np.ndarray  # (t, h, w, 3) uint8
    texts: List[str]


def marked(frames: np.ndarray, use: int) -> np.ndarray:
    """The frames of use number `use` (a copy, first pixel marked)."""
    out = frames.copy()
    out[0, 0, 0] = (use % 256, (use // 256) % 256, (use // 65536) % 256)
    return out


class Videos:
    def __init__(self, mix: Dict, seed: int, device):
        rng = np.random.default_rng(int(seed))
        h, w = mix["frame_size"]
        self.original_size: Tuple[int, int] = tuple(mix["original_size"])
        cycle = np.random.default_rng(int(mix["cycle_seed"])).permutation(len(mix["pool"]))
        order = np.roll(cycle, -int(rng.integers(len(cycle))))
        self.pool: List[Video] = []
        gen = torch.Generator(device=device).manual_seed(int(seed))
        lo, hi = mix["words_per_expression"]
        vocab = mix["vocabulary"]
        for i in order:
            t, n_expr = mix["pool"][i]
            frames = torch.randint(0, 256, (t, h, w, 3), generator=gen, device=device,
                                   dtype=torch.uint8).cpu().numpy()
            texts = [" ".join(rng.choice(vocab, int(rng.integers(lo, hi + 1))))
                     for _ in range(n_expr)]
            self.pool.append(Video(frames, texts))
        self.uses = 0

    def item(self, index: int, use: int) -> Dict:
        v = self.pool[index]
        return dict(frames=marked(v.frames, use), texts=v.texts,
                    original_size=self.original_size)

    def next(self) -> Tuple[int, int, Dict]:
        """(pool index, use number, engine item) of the loop's next video."""
        use = self.uses
        self.uses += 1
        index = use % len(self.pool)
        return index, use, self.item(index, use)

    def sample(self, seed: int, k: int) -> List[int]:
        """Pool indices to check: the longest video, the one with the most
        expressions, and `k` more drawn from the seed."""
        n = len(self.pool)
        longest = max(range(n), key=lambda i: (self.pool[i].frames.shape[0], i))
        most = max(range(n), key=lambda i: (len(self.pool[i].texts), i))
        rest = [i for i in np.random.default_rng(int(seed) + 1).permutation(n)
                if i not in (longest, most)]
        return sorted({longest, most, *rest[:k]})


def make(mix: Dict, seed: int, device) -> Videos:
    return Videos(mix, seed, device)
