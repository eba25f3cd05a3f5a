"""COCO-protocol mask mAP without pycocotools (the port's copy of
neurips2023_soc_tpu/evaluation/coco_eval.py).

The COCOeval(segm, useCats=0) protocol the reference uses for A2D/JHMDB
(trainer.py:295-310), over its dummy single category: greedy score-ordered
matching per IoU threshold 0.5:0.05:0.95, area ranges all/small/medium/large,
maxDets=100, 101-point interpolated precision. Plus the reference's
P@0.5..0.9 and overall/mean IoU (metrics.py:35-60).

Annotation dicts follow the COCO json convention:
  gt:  {image_id, segmentation (rle dict), area, iscrowd, id}
  dt:  {image_id, segmentation, score}
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from .rle import area as rle_area
from .rle import decode as rle_decode
from .rle import iou as rle_iou

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _evaluate_img(dts: List[Dict], gts: List[Dict], ious: np.ndarray,
                  area_rng: Tuple[float, float]):
    """Greedy matching for one image + one area range, all IoU thresholds.

    Returns (dt_matches (T, D), dt_ignore (T, D), gt_ignore (G,), dt_scores)."""
    T = len(IOU_THRS)
    gt_ignore = np.array(
        [g.get("iscrowd", 0) == 1 or not (area_rng[0] <= g["area"] <= area_rng[1])
         for g in gts], bool,
    )
    # sort gts: non-ignored first (pycocotools convention)
    g_order = np.argsort(gt_ignore, kind="stable")
    gts_sorted = [gts[i] for i in g_order]
    gt_ignore = gt_ignore[g_order]
    ious = ious[:, g_order] if len(gts) else ious

    D = len(dts)
    G = len(gts)
    dtm = np.zeros((T, D), np.int64)
    dt_ig = np.zeros((T, D), bool)
    gtm = np.zeros((T, G), bool)
    for ti, thr in enumerate(IOU_THRS):
        for di in range(D):
            best = -1
            best_iou = min(thr, 1 - 1e-10)
            for gi in range(G):
                if gtm[ti, gi] and gts_sorted[gi].get("iscrowd", 0) != 1:
                    continue
                # stop at ignored gts once a real match was found
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            dtm[ti, di] = 1
            dt_ig[ti, di] = gt_ignore[best]
            gtm[ti, best] = True
    # dts outside the area range and unmatched are ignored
    a = np.array(
        [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts], bool
    )
    dt_ig = dt_ig | (np.broadcast_to(a[None], (T, D)) & (dtm == 0))
    n_gt = int((~gt_ignore).sum())
    return dtm, dt_ig, n_gt


def evaluate_coco_map(gt_anns: List[Dict], dt_anns: List[Dict]) -> Dict[str, float]:
    """Category-agnostic segm mAP over all images."""
    gt_by_img = defaultdict(list)
    for g in gt_anns:
        g = dict(g)
        if "area" not in g:
            g["area"] = rle_area(g["segmentation"])
        gt_by_img[g["image_id"]].append(g)
    dt_by_img = defaultdict(list)
    for d in dt_anns:
        d = dict(d)
        if "area" not in d:
            d["area"] = rle_area(d["segmentation"])
        dt_by_img[d["image_id"]].append(d)

    # include det-only images: their detections are FPs (pycocotools walks
    # the GT dataset's full image list, so an image with no GT annotations
    # still contributes false positives)
    img_ids = sorted(set(gt_by_img) | set(dt_by_img))
    results = {}
    # per image, per area range
    per_rng: Dict[str, List] = {k: [] for k in AREA_RNGS}
    for img in img_ids:
        gts = gt_by_img[img]
        dts = sorted(dt_by_img.get(img, []), key=lambda d: -d["score"])[:MAX_DETS]
        ious = rle_iou(
            [d["segmentation"] for d in dts],
            [g["segmentation"] for g in gts],
            [g.get("iscrowd", 0) for g in gts],
        ) if dts and gts else np.zeros((len(dts), len(gts)))
        for rng_name, rng in AREA_RNGS.items():
            dtm, dt_ig, n_gt = _evaluate_img(dts, gts, ious, rng)
            scores = np.array([d["score"] for d in dts])
            per_rng[rng_name].append((dtm, dt_ig, scores, n_gt))

    def ap_for(rng_name: str, thr_idx=None) -> float:
        entries = per_rng[rng_name]
        n_gt = sum(e[3] for e in entries)
        if n_gt == 0:
            return -1.0  # pycocotools convention for empty area ranges
        T = len(IOU_THRS)
        dtm = np.concatenate([e[0] for e in entries], axis=1)
        dt_ig = np.concatenate([e[1] for e in entries], axis=1)
        scores = np.concatenate([e[2] for e in entries])
        order = np.argsort(-scores, kind="mergesort")
        dtm = dtm[:, order]
        dt_ig = dt_ig[:, order]
        aps = []
        thr_list = range(T) if thr_idx is None else [thr_idx]
        for ti in thr_list:
            keep = ~dt_ig[ti]
            tps = np.cumsum((dtm[ti] == 1) & keep)
            fps = np.cumsum((dtm[ti] == 0) & keep)
            rc = tps / n_gt
            pr = tps / np.maximum(tps + fps, 1e-10)
            # make precision monotonically decreasing
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, RECALL_THRS, side="left")
            q = np.zeros(len(RECALL_THRS))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            aps.append(q.mean())
        return float(np.mean(aps))

    results["mAP 0.5:0.95"] = ap_for("all")
    results["AP 0.5"] = ap_for("all", 0)
    results["AP 0.75"] = ap_for("all", 5)
    results["AP 0.5:0.95 S"] = ap_for("small")
    results["AP 0.5:0.95 M"] = ap_for("medium")
    results["AP 0.5:0.95 L"] = ap_for("large")
    return results


def precision_at_k_and_iou(gt_anns: List[Dict], dt_anns: List[Dict]):
    """P@0.5..0.9 + overall/mean IoU (reference metrics.py:35-60):
    one gt instance per image; the top-scoring prediction is compared."""
    gt_by_img = {g["image_id"]: g for g in gt_anns}
    dt_by_img = defaultdict(list)
    for d in dt_anns:
        dt_by_img[d["image_id"]].append(d)

    counters = {t: 0 for t in (0.5, 0.6, 0.7, 0.8, 0.9)}
    total_i = total_u = 0.0
    ious = []
    for img, g in gt_by_img.items():
        preds = dt_by_img.get(img, [])
        if not preds:
            ious.append(0.0)
            continue
        best = max(preds, key=lambda a: a["score"])
        gm = rle_decode(g["segmentation"]).astype(bool)
        dm = rle_decode(best["segmentation"]).astype(bool)
        inter = float(np.logical_and(gm, dm).sum())
        union = float(np.logical_or(gm, dm).sum())
        iou_v = (inter + 1e-6) / (union + 1e-6)
        for t in counters:
            if iou_v > t:
                counters[t] += 1
        total_i += inter
        total_u += union
        ious.append(iou_v)
    n = max(len(ious), 1)
    out = {f"P@{t}": counters[t] / n for t in counters}
    out["overall_iou"] = total_i / max(total_u, 1e-6)
    out["mean_iou"] = float(np.mean(ious)) if ious else 0.0
    return out
