"""RefExp box evaluation (the port's copy of
neurips2023_soc_tpu/evaluation/refexp_eval.py; reference
datasets/coco/refexp_eval.py:13-85): recall@k of predicted boxes against the
referred GT box, and the pretrainer's box P@K / IoU (reference
metrics.py:62-94)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N,4), b (M,4) xyxy -> (N,M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-6)


def evaluate_refexp_recall(
    gt_boxes_by_img: Dict, dt_by_img: Dict,
    ks: Sequence[int] = (1, 5, 10), iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """gt_boxes_by_img: image_id -> (G, 4) xyxy; dt_by_img: image_id ->
    list of {'box': xyxy, 'score': float}."""
    counts = {k: 0 for k in ks}
    n = 0
    for img_id, gt in gt_boxes_by_img.items():
        gt = np.asarray(gt, np.float32).reshape(-1, 4)
        dts = sorted(dt_by_img.get(img_id, []), key=lambda d: -d["score"])
        if not dts:
            n += 1
            continue
        boxes = np.asarray([d["box"] for d in dts], np.float32)
        iou = _box_iou(boxes, gt).max(-1)  # best IoU per prediction
        for k in ks:
            if (iou[:k] > iou_thresh).any():
                counts[k] += 1
        n += 1
    return {f"recall@{k}": counts[k] / max(n, 1) for k in ks}


def bbox_precision_at_k_and_iou(
    gt_boxes_by_img: Dict, dt_by_img: Dict,
) -> Dict[str, float]:
    """Top-scoring box vs the single referred GT box (reference metrics.py:62-94)."""
    counters = {t: 0 for t in (0.5, 0.6, 0.7, 0.8, 0.9)}
    total_i = total_u = 0.0
    ious = []
    for img_id, gt in gt_boxes_by_img.items():
        gt = np.asarray(gt, np.float32).reshape(-1, 4)[:1]
        dts = dt_by_img.get(img_id, [])
        if not dts:
            ious.append(0.0)
            continue
        best = max(dts, key=lambda d: d["score"])
        b = np.asarray(best["box"], np.float32)[None]
        lt = np.maximum(b[:, :2], gt[:, :2])
        rb = np.minimum(b[:, 2:], gt[:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = float(wh[0, 0] * wh[0, 1])
        area_b = float((b[0, 2] - b[0, 0]) * (b[0, 3] - b[0, 1]))
        area_g = float((gt[0, 2] - gt[0, 0]) * (gt[0, 3] - gt[0, 1]))
        union = area_b + area_g - inter
        iou = (inter + 1e-6) / (union + 1e-6)
        for t in counters:
            if iou > t:
                counters[t] += 1
        total_i += inter
        total_u += union
        ious.append(iou)
    n = max(len(ious), 1)
    out = {f"bbox P@{t}": counters[t] / n for t in counters}
    out["bbox overall_iou"] = total_i / max(total_u, 1e-6)
    out["bbox mean_iou"] = float(np.mean(ious)) if ious else 0.0
    return out
