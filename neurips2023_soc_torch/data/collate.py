"""Collation of per-sample videos and targets into fixed-shape batches (the
port's numpy copy of neurips2023_soc_tpu/data/collate.py).

Every array is padded to bucketed static shapes. Batch dict (numpy, host):
  pixels:    (T, B, H, W, 3) float32, ImageNet-normalized
  pad_mask:  (T, B, H, W)    bool
  text_ids:  (B, S) int32        text_mask: (B, S) int32
  sample_sizes: (B, 2) float32   resized (h, w) before padding
  valid_indices: (B,) int32      only for center-frame datasets (A2D)
  targets:   masks (T,B,N,H,W) f32; boxes (T,B,N,4) cxcywh-normalized;
             labels (B,N); inst_valid (B,N); is_ref_inst_visible (T,B,N);
             referred_instance_idx (B,)
plus host metadata (resized_sizes, image_ids, orig_sizes, videos_metadata)
that the train step drops.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils.padded import (DEFAULT_SIZE_BUCKETS, DEFAULT_TIME_BUCKETS, pick_size_bucket,
                            pick_time_bucket)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_frames(frames: np.ndarray) -> np.ndarray:
    """uint8/float (T, H, W, 3) -> normalized float32."""
    x = frames.astype(np.float32)
    if x.max() > 2.0:
        x = x / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def frames_to_uint8(frames) -> np.ndarray:
    """[0, 1] float frames (exact u8 / 255 values out of the resize) -> raw
    uint8 pixels for the engine, which normalizes them on the device
    (inference._normalize_u8_in_graph)."""
    return np.round(np.stack(frames) * 255.0).astype(np.uint8)


def collate_batch(samples: List[Dict], tokenizer, max_instances: int = 1,
                  size_buckets=DEFAULT_SIZE_BUCKETS, time_buckets=DEFAULT_TIME_BUCKETS,
                  with_targets: bool = True) -> Dict[str, np.ndarray]:
    """samples: dicts with frames (T, h, w, 3) float32 normalized, text str,
    masks (T, n, h, w) uint8, boxes (T, n, 4) xyxy absolute px, labels (n,),
    is_visible (T, n) bool, referred_instance_idx int."""
    B = len(samples)
    t_max = max(s["frames"].shape[0] for s in samples)
    h_max = max(s["frames"].shape[1] for s in samples)
    w_max = max(s["frames"].shape[2] for s in samples)
    T = pick_time_bucket(t_max, time_buckets)
    H, W = pick_size_bucket(h_max, w_max, size_buckets)
    N = max_instances

    pixels = np.zeros((T, B, H, W, 3), np.float32)
    pad_mask = np.ones((T, B, H, W), bool)
    sample_sizes = np.zeros((B, 2), np.float32)
    batch: Dict[str, np.ndarray] = {}
    # center-frame datasets: the targets' time axis holds the annotated frames
    has_valid_idx = any("valid_frame_idx" in s for s in samples)

    if with_targets:
        Tt = max(s["masks"].shape[0] for s in samples) if has_valid_idx else T
        masks = np.zeros((Tt, B, N, H, W), np.float32)
        boxes = np.zeros((Tt, B, N, 4), np.float32)
        labels = np.zeros((B, N), np.int32)
        inst_valid = np.zeros((B, N), bool)
        visible = np.zeros((Tt, B, N), bool)
        ref_idx = np.zeros((B,), np.int32)

    for b, s in enumerate(samples):
        f = s["frames"]
        t, h, w = f.shape[:3]
        pixels[:t, b, :h, :w] = f
        # padded time slots repeat the last frame (they carry no loss)
        if t < T:
            pixels[t:T, b, :h, :w] = f[-1]
        pad_mask[:, b, :h, :w] = False
        sample_sizes[b] = (h, w)
        if with_targets:
            n = min(s["masks"].shape[1], N)
            tt = s["masks"].shape[0]
            masks[:tt, b, :n, :h, :w] = s["masks"][:, :n]
            # cxcywh normalized by the resized (unpadded) sample size
            bx = s["boxes"][:, :n].astype(np.float32)
            cx = (bx[..., 0] + bx[..., 2]) / 2 / w
            cy = (bx[..., 1] + bx[..., 3]) / 2 / h
            bw = (bx[..., 2] - bx[..., 0]) / w
            bh = (bx[..., 3] - bx[..., 1]) / h
            boxes[:tt, b, :n] = np.stack([cx, cy, bw, bh], -1)
            labels[b, :n] = s.get("labels", np.zeros(n))[:n]
            inst_valid[b, :n] = True
            visible[:tt, b, :n] = s["is_visible"][:, :n]
            ref_idx[b] = s.get("referred_instance_idx", 0)

    text_ids, text_mask = tokenizer([s["text"] for s in samples])
    batch.update(pixels=pixels, pad_mask=pad_mask, text_ids=text_ids, text_mask=text_mask,
                 sample_sizes=sample_sizes)
    if with_targets:
        batch.update(masks=masks, boxes=boxes, labels=labels, inst_valid=inst_valid,
                     is_ref_inst_visible=visible, referred_instance_idx=ref_idx)
    if has_valid_idx:
        batch["valid_indices"] = np.array(
            [s.get("valid_frame_idx", 0) for s in samples], np.int32)
    batch["resized_sizes"] = [tuple(s["frames"].shape[1:3]) for s in samples]
    if all("image_id" in s for s in samples):
        batch["image_ids"] = [s["image_id"] for s in samples]
    if all("orig_size" in s for s in samples):
        batch["orig_sizes"] = [tuple(s["orig_size"]) for s in samples]
    if all("video_metadata" in s for s in samples):
        batch["videos_metadata"] = [s["video_metadata"] for s in samples]
    return batch
