"""The train step worked out again: the batch padded to its size bucket, the
forward in training mode with dropout and drop path drawn from a generator
reseeded every step, the criterion with its Hungarian match, the backward,
the global-norm clip and a plain AdamW over three groups (the backbone, the
text encoder, the rest), the frozen text encoder left out.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .common import precision_of
from .criterion import Matches, compute_criterion, total_loss
from .padded import DEFAULT_TIME_BUCKETS, pick_size_bucket, pick_time_bucket
from .text_encoder import build_tokenizer

TARGET_KEYS = ("masks", "boxes", "labels", "inst_valid", "is_ref_inst_visible",
               "referred_instance_idx")


def collate(samples: Sequence[Mapping], size_buckets, text_encoder_type: str,
            text_bucket: int, device) -> Dict[str, torch.Tensor]:
    """Samples of t frames: frames (t, h, w, 3) float32 normalized, text,
    one instance's masks (t, h, w), xyxy boxes (t, 4) in pixels and
    visibility (t,). Returns the batch padded to its time and size buckets
    (time-major) on `device`; padded frames repeat the last one and carry no
    target."""
    B, t = len(samples), samples[0]["frames"].shape[0]
    T = pick_time_bucket(t, DEFAULT_TIME_BUCKETS)
    H, W = pick_size_bucket(max(s["frames"].shape[1] for s in samples),
                            max(s["frames"].shape[2] for s in samples), size_buckets)
    pixels = np.zeros((T, B, H, W, 3), np.float32)
    pad = np.ones((T, B, H, W), bool)
    masks = np.zeros((T, B, 1, H, W), np.float32)
    boxes = np.zeros((T, B, 1, 4), np.float32)
    sizes = np.zeros((B, 2), np.float32)
    visible = np.zeros((T, B, 1), bool)
    for b, s in enumerate(samples):
        _, h, w, _ = s["frames"].shape
        pixels[:t, b, :h, :w] = s["frames"]
        pixels[t:, b, :h, :w] = s["frames"][-1]
        pad[:, b, :h, :w] = False
        masks[:t, b, 0, :h, :w] = s["masks"]
        x0, y0, x1, y1 = (s["boxes"][:, i].astype(np.float32) for i in range(4))
        boxes[:t, b, 0] = np.stack([(x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                                   (x1 - x0) / w, (y1 - y0) / h], -1)
        sizes[b] = (h, w)
        visible[:t, b, 0] = s["visible"]
    ids, msk = build_tokenizer(text_encoder_type, text_bucket)([s["text"] for s in samples])
    batch = dict(pixels=pixels, pad_mask=pad, text_ids=ids, text_mask=msk,
                 sample_sizes=sizes, masks=masks, boxes=boxes,
                 labels=np.zeros((B, 1), np.int32), inst_valid=np.ones((B, 1), bool),
                 is_ref_inst_visible=visible, referred_instance_idx=np.zeros(B, np.int32))
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def group_of(name: str, freeze_text: bool) -> str:
    if name.startswith("backbone."):
        return "backbone"
    if name.startswith("text_encoder."):
        return "frozen" if freeze_text else "text"
    return "main"


class AdamW:
    """Adam with decoupled weight decay scaled by the lr, betas (0.9, 0.999),
    eps 1e-8, bias-corrected; the gradients first clipped to a global norm.
    A trainable parameter the loss does not reach gets a zero gradient."""

    def __init__(self, named: Mapping[str, torch.nn.Parameter], lrs: Mapping[str, float],
                 weight_decay: float, clip_max_norm: float, freeze_text: bool):
        self.params = {n: p for n, p in named.items()
                       if group_of(n, freeze_text) != "frozen"}
        self.lr = {n: lrs[group_of(n, freeze_text)] for n in self.params}
        self.wd, self.clip = weight_decay, clip_max_norm
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for n, p in self.params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if self.clip > 0:
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = {n: g * scale for n, g in grads.items()}
        self.count += 1
        c1, c2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        for n, p in self.params.items():
            g, m, v = grads[n], self.m[n], self.v[n]
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.mul_(1 - self.lr[n] * self.wd)
            p.sub_(self.lr[n] / c1 * m / (v.sqrt() / math.sqrt(c2) + 1e-8))
            p.grad = None
        return grads


def reference_steps(model, batches: Sequence[Dict[str, torch.Tensor]], seeds: Sequence[int],
                    crit_cfg, cfg: Mapping, matches: Optional[Matches] = None) -> Dict[str, object]:
    """Runs the steps; returns each step's loss, the first step's clipped
    gradients, the parameters after the last step (float32, on the device)
    and the Matches (given ones followed, see criterion.Matches)."""
    matches = Matches() if matches is None else matches
    opt = AdamW(dict(model.named_parameters()),
                {"main": cfg["lr"], "backbone": cfg["lr_backbone"],
                 "text": cfg["text_encoder_lr"]},
                cfg["weight_decay"], cfg["clip_max_norm"], cfg["freeze_text_encoder"])
    device = next(model.parameters()).device
    rng = torch.Generator(device=device)
    model.train()
    losses: List[float] = []
    first = None
    for b, seed in zip(batches, seeds):
        rng.manual_seed(int(seed))
        with precision_of(model):
            out = model(b["pixels"], b["pad_mask"], b["text_ids"], b["text_mask"],
                        sample_sizes=b["sample_sizes"], training=True, rng=rng)
            loss = total_loss(compute_criterion(out, {k: b[k] for k in TARGET_KEYS},
                                                crit_cfg, matches), crit_cfg)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = opt.step()
        if first is None:
            first = grads
    return {"losses": losses, "grads": first, "matches": matches,
            "params": {n: p.detach() for n, p in opt.params.items()}}
