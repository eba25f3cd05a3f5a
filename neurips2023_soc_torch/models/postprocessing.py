"""Postprocessors (the port's counterpart of
neurips2023_soc_tpu/models/postprocessing.py, reference
models/postprocessing.py).

The split is the JAX file's: everything up to binary masks at the padded
input size (upsample, sigmoid, threshold, trajectory and top-k selection)
runs on the device of its inputs; the per-sample unpad, resize to the
original size and RLE encoding run on the host, because samples differ in
size. Sigmoids are taken in float32. Resizes are the port's own
(`ops.resize`), which pick source pixels as the JAX package does;
`F.interpolate(mode="nearest")` does not.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear, resize_nearest
from ..utils.boxes import box_cxcywh_to_xyxy


def _upsample_threshold(logits: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """(..., h, w) mask logits -> (..., pad_h, pad_w) bool: bilinear
    upsample (align_corners=False) in float32, sigmoid > 0.5."""
    up = resize_bilinear(logits[..., None].float(), pad_h, pad_w, align_corners=False)
    return torch.sigmoid(up[..., 0]) > 0.5


def a2d_device_step(pred_cls: torch.Tensor, pred_masks: torch.Tensor, pad_h: int,
                    pad_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Last-layer outputs -> per-frame scores and binary masks at the padded
    size (reference A2DSentencesPostProcess, models/postprocessing.py:17-46).

    pred_cls: (T, B, Nq, K); pred_masks: (T, B, Nq, h, w).
    Returns scores (T*B, Nq) float32 and masks (T*B, Nq, pad_h, pad_w) bool.
    """
    T, B, Nq = pred_cls.shape[:3]
    scores = torch.sigmoid(pred_cls[..., 0].float()).reshape(T * B, Nq)
    masks = pred_masks.reshape(T * B, Nq, *pred_masks.shape[-2:])
    return scores, _upsample_threshold(masks, pad_h, pad_w)


def _unpad_resize(masks: torch.Tensor, h: int, w: int, oh: int, ow: int) -> np.ndarray:
    """(..., H, W) bool host masks -> the (h, w) content resized (nearest) to
    (oh, ow), as uint8."""
    return resize_nearest(masks[..., :h, :w, None], int(oh), int(ow))[..., 0].to(
        torch.uint8).numpy()


def a2d_host_postprocess(scores: torch.Tensor, masks: torch.Tensor,
                         resized_sizes: Sequence[Tuple[int, int]],
                         orig_sizes: Sequence[Tuple[int, int]]) -> List[Dict]:
    """The host half of a2d_postprocess, on a2d_device_step's outputs as CPU
    tensors: per frame, unpad to the resized size, resize (nearest) to the
    original size and RLE-encode every query's mask."""
    from ..evaluation.rle import encode as rle_encode

    predictions = []
    for f_masks, f_scores, (h, w), (oh, ow) in zip(masks, scores, resized_sizes, orig_sizes):
        resized = _unpad_resize(f_masks, h, w, oh, ow)
        predictions.append({"scores": f_scores.numpy(), "masks": resized,
                            "rle_masks": [rle_encode(m) for m in resized]})
    return predictions


def a2d_postprocess(outputs: Dict[str, torch.Tensor], resized_padded_size: Tuple[int, int],
                    resized_sizes: Sequence[Tuple[int, int]],
                    orig_sizes: Sequence[Tuple[int, int]]) -> List[Dict]:
    """Full A2D postprocess: the device step, then the host unpad, resize and
    RLE."""
    scores, masks = a2d_device_step(outputs["pred_cls"][-1], outputs["pred_masks"][-1],
                                    *resized_padded_size)
    return a2d_host_postprocess(scores.cpu(), masks.cpu(), resized_sizes, orig_sizes)


def ytvos_device_step(pred_cls: torch.Tensor, pred_masks: torch.Tensor, pad_h: int,
                      pad_w: int) -> torch.Tensor:
    """Whole-video trajectory selection and mask binarization (reference
    ReferYoutubeVOSPostProcess, models/postprocessing.py:200-221).

    pred_cls: (T, B, Nq, K); pred_masks: (T, B, Nq, h, w).
    Returns (B, T, pad_h, pad_w) bool masks of the selected trajectory (the
    query of the highest mean score; the first one on a tie).
    """
    prob = torch.sigmoid(pred_cls.float()).mean(0)  # (B, Nq, K)
    traj = prob.amax(-1).argmax(-1)  # (B,)
    masks = pred_masks.transpose(0, 1)  # (B, T, Nq, h, w)
    B, T, _, h, w = masks.shape
    sel = masks.gather(2, traj.view(B, 1, 1, 1, 1).expand(B, T, 1, h, w))[:, :, 0]
    return _upsample_threshold(sel, pad_h, pad_w)


def ytvos_postprocess(outputs: Dict[str, torch.Tensor], videos_metadata: List[Dict],
                      padded_size: Tuple[int, int]) -> List[Dict]:
    masks = ytvos_device_step(outputs["pred_cls"][-1], outputs["pred_masks"][-1],
                              *padded_size).cpu()
    preds = []
    for vid_masks, meta in zip(masks, videos_metadata):
        rh, rw = meta["resized_frame_size"]
        oh, ow = meta["original_frame_size"]
        preds.append({**meta, "pred_masks": _unpad_resize(vid_masks, rh, rw, oh, ow)})
    return preds


def coco_topk_device_step(pred_cls: torch.Tensor, pred_boxes: torch.Tensor):
    """Top-k box selection (reference PostProcess, models/postprocessing.py:60-95).

    pred_cls: (T, B, Nq, K); pred_boxes: (T, B, Nq, 4) cxcywh. Returns scores
    (B, T*Nq), labels (B, T*Nq) and boxes (B, T*Nq, 4) xyxy, normalized. Equal
    scores keep their index order, as jax.lax.top_k does."""
    T, B, Nq, K = pred_cls.shape
    logits = pred_cls.permute(1, 0, 2, 3).reshape(B, T * Nq, K)
    boxes = box_cxcywh_to_xyxy(pred_boxes.permute(1, 0, 2, 3).reshape(B, T * Nq, 4))
    prob = torch.sigmoid(logits.float()).reshape(B, -1)
    topv, topi = torch.sort(prob, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :T * Nq], topi[:, :T * Nq]
    labels = topi % K
    boxes = boxes.gather(1, (topi // K)[..., None].expand(B, T * Nq, 4))
    return topv, labels, boxes
