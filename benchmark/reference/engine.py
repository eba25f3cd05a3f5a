"""The engine's arithmetic worked out again: time and size buckets, the
padded clip (padded frames repeat the last one, padded pixels are zero and
masked), ImageNet normalization, the hash tokens, the forward, the whole-video
trajectory choice and the finalize step's resizes, kept as logits in float32.

`reference_video` returns, per expression, the per-query score sums over the
real frames and a function that gives one query's mask logits at the
original size; a logit above 0 is a mask pixel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .common import precision_of
from .padded import pick_size_bucket, pick_time_bucket
from .resize import resize_bilinear
from .text_encoder import build_tokenizer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def padded_clip(frames: np.ndarray, T: int, H: int, W: int, device) -> Tuple[torch.Tensor,
                                                                             torch.Tensor]:
    """uint8 (t, h, w, 3) -> normalized float32 pixels (T, 1, H, W, 3) and the
    pad mask (T, 1, H, W), True outside the frame."""
    t, h, w, _ = frames.shape
    buf = torch.zeros(T, 1, H, W, 3, dtype=torch.uint8)
    buf[:t, 0, :h, :w] = torch.from_numpy(frames)
    buf[t:, 0, :h, :w] = torch.from_numpy(frames[-1])
    pad = torch.ones(T, 1, H, W, dtype=torch.bool)
    pad[:, :, :h, :w] = False
    buf, pad = buf.to(device), pad.to(device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    x = (buf.float() / 255.0 - mean) / std
    return x.masked_fill(pad[..., None], 0.0), pad


def _forward_chunks(model, frames, toks, per_text, time_buckets, H, W, chunk, device):
    """Backbone once per chunk, head once per text; scores and stride-4 logits
    of the real frames into per_text."""
    t_total = frames.shape[0]
    for start in range(0, t_total, chunk):
        clip = frames[start:start + chunk]
        t = clip.shape[0]
        pixels, pad = padded_clip(clip, pick_time_bucket(t, time_buckets), H, W, device)
        feats = model.backbone_features(pixels, pad)
        for k, (ids, msk) in enumerate(toks):
            out = model.head(feats, pad, ids, msk)
            scores = torch.sigmoid(out["pred_cls"][-1].float())[:, 0].amax(-1)  # (T, Nq)
            per_text[k]["scores"] = per_text[k]["scores"] + scores[:t].double().sum(0)
            per_text[k]["chunks"].append((out["pred_masks"][-1][:t, 0].float(), t))


@torch.no_grad()
def reference_video(model, frames: np.ndarray, texts: Sequence[str],
                    original_size: Tuple[int, int], time_buckets: Sequence[int],
                    size_buckets: Sequence[Tuple[int, int]], text_encoder_type: str,
                    text_bucket: int) -> List[Dict]:
    """frames: uint8 (t, h, w, 3). Returns per text {"scores": (Nq,) float64
    sums over the real frames of each query's sigmoid class score, "logits":
    fn(query) -> (t, oh, ow) float32 mask logits at the original size}."""
    device = next(model.parameters()).device
    tokenize = build_tokenizer(text_encoder_type, text_bucket)
    toks = [tuple(torch.from_numpy(a).to(device) for a in tokenize([s])) for s in texts]
    t_total, fh, fw, _ = frames.shape
    H, W = pick_size_bucket(fh, fw, size_buckets)
    oh, ow = original_size
    chunk = max(time_buckets)
    per_text = [{"scores": 0.0, "chunks": []} for _ in texts]
    with precision_of(model):
        _forward_chunks(model, frames, toks, per_text, time_buckets, H, W, chunk, device)

    def logits_fn(chunks) -> Callable[[int], torch.Tensor]:
        def fn(q: int) -> torch.Tensor:
            parts = []
            for logits, _ in chunks:
                up = resize_bilinear(logits[:, q, :, :, None], H, W)[..., 0]
                content = up[:, :fh, :fw]
                if (oh, ow) != (fh, fw):
                    content = resize_bilinear(content[..., None], oh, ow)[..., 0]
                parts.append(content)
            return torch.cat(parts)
        return fn

    return [{"scores": r["scores"].cpu().numpy(), "logits": logits_fn(r["chunks"])}
            for r in per_text]
