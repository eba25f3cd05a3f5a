"""The model's FLOPs at given shapes: the reference SOC run on the meta
device under torch's FLOP counter (matmuls, convolutions and their
backward), so nothing is computed and nothing is allocated. Counted at the
real frames a video has, not at the bucket the program pads it to.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import build_reference


def _inputs(T: int, B: int, H: int, W: int, S: int):
    pixels = torch.zeros(T, B, H, W, 3, device="meta")
    pad = torch.zeros(T, B, H, W, dtype=torch.bool, device="meta")
    ids = torch.zeros(B, S, dtype=torch.int32, device="meta")
    mask = torch.ones(B, S, dtype=torch.int32, device="meta")
    return pixels, pad, ids, mask


class ModelWork:
    """FLOPs of one configuration's SOC, memoized per shape."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        with torch.device("meta"):
            self.model = build_reference(cfg)

    @functools.lru_cache(maxsize=None)
    def inference(self, T: int, H: int, W: int) -> Tuple[float, float]:
        """(backbone FLOPs, head FLOPs per expression) of one T-frame clip."""
        pixels, pad, ids, mask = _inputs(T, 1, H, W, self.cfg["text_bucket"])
        self.model.requires_grad_(False)
        with FlopCounterMode(display=False) as fc:
            feats = self.model.backbone_features(pixels, pad)
        backbone = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            self.model.head(feats, pad, ids, mask)
        return float(backbone), float(fc.get_total_flops())

