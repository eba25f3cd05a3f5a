"""DAVIS-2017 J&F in numpy (the port's copy of
neurips2023_soc_tpu/evaluation/davis.py, reference davis2017/ package).

J = region Jaccard (davis2017/metrics.py:6-37); F = boundary F-measure via
1-pixel boundary maps dilated by a disk of radius ceil(0.008 * diag)
(metrics.py:40-121); statistics = mean / recall@0.5 / decay over 4 temporal
bins (utils.py:135-150). The unsupervised task Hungarian-matches proposals to
ground-truth objects by (J+F)/2 (evaluation.py:44-66).

The disk dilation runs per disk row on a running sum (one pass per row
width of the disk, not per pixel of it), so the port needs no OpenCV; it
gives the same boolean map as cv2.dilate and the JAX file's shift-or.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Tuple

import numpy as np


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray,
                void_pixels: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-frame Jaccard. Arrays (..., H, W) binary; empty∩empty -> 1."""
    a = annotation.astype(bool)
    s = segmentation.astype(bool)
    keep = ~void_pixels.astype(bool) if void_pixels is not None else np.ones_like(s)
    inters = np.sum((s & a) & keep, axis=(-2, -1))
    union = np.sum((s | a) & keep, axis=(-2, -1))
    j = inters / np.maximum(union, 1)
    return np.where(np.isclose(union, 0), 1.0, j)


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map (public BSDS seg2bmap, equal-size case)."""
    seg = seg.astype(bool)
    h, w = seg.shape
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _dilate(m: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation by the disk x^2 + y^2 <= radius^2. Disk row dy spans
    |dx| <= isqrt(radius^2 - dy^2): each row width's horizontal dilation comes
    from a running sum along the rows, and the rows are OR-ed in shifted."""
    mb = m.astype(bool)
    if radius <= 0:
        return mb
    h, w = mb.shape
    r = radius
    cs = np.zeros((h, w + 2 * r + 1), np.int32)
    np.cumsum(np.pad(mb, ((0, 0), (r, r))), axis=1, out=cs[:, 1:])
    rows = {}
    out = np.zeros_like(mb)
    for dy in range(-min(r, h - 1), min(r, h - 1) + 1):
        k = math.isqrt(r * r - dy * dy)
        if k not in rows:
            rows[k] = (cs[:, r + k + 1:r + k + 1 + w] - cs[:, r - k:r - k + w]) > 0
        src = rows[k]
        out[max(0, dy):h + min(0, dy)] |= src[max(0, -dy):h + min(0, -dy)]
    return out


def f_measure(foreground_mask: np.ndarray, gt_mask: np.ndarray,
              void_pixels: Optional[np.ndarray] = None,
              bound_th: float = 0.008) -> float:
    keep = (~void_pixels.astype(bool)) if void_pixels is not None else None
    fg = foreground_mask.astype(bool) & keep if keep is not None else foreground_mask.astype(bool)
    gt = gt_mask.astype(bool) & keep if keep is not None else gt_mask.astype(bool)

    bound_pix = bound_th if bound_th >= 1 else \
        int(np.ceil(bound_th * np.linalg.norm(foreground_mask.shape)))

    fg_boundary = _seg2bmap(fg)
    gt_boundary = _seg2bmap(gt)
    fg_dil = _dilate(fg_boundary, int(bound_pix))
    gt_dil = _dilate(gt_boundary, int(bound_pix))

    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match.sum() / float(n_fg)
        recall = gt_match.sum() / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def db_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray,
                     void_pixels: Optional[np.ndarray] = None,
                     bound_th: float = 0.008) -> np.ndarray:
    if annotation.ndim == 3:
        return np.array([
            f_measure(segmentation[t], annotation[t],
                      None if void_pixels is None else void_pixels[t], bound_th)
            for t in range(annotation.shape[0])
        ])
    return np.asarray(f_measure(segmentation, annotation, void_pixels, bound_th))


def db_statistics(per_frame_values: np.ndarray) -> Tuple[float, float, float]:
    """mean, recall(>0.5), decay over 4 temporal bins."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        M = np.nanmean(per_frame_values)
        O = np.nanmean(per_frame_values > 0.5)
        N_bins = 4
        ids = np.round(np.linspace(1, len(per_frame_values), N_bins + 1) + 1e-10) - 1
        ids = ids.astype(np.uint8)
        D_bins = [per_frame_values[ids[i] : ids[i + 1] + 1] for i in range(4)]
        D = np.nanmean(D_bins[0]) - np.nanmean(D_bins[3])
    return float(M), float(O), float(D)


def evaluate_unsupervised(
    all_gt_masks: np.ndarray,  # (n_obj, T, H, W)
    all_res_masks: np.ndarray,  # (n_prop, T, H, W)
    metric=("J", "F"),
    max_n_proposals: int = 20,
):
    """Hungarian-match proposals to objects by mean (J+F)/2, then return the
    matched per-frame J and F (reference evaluation.py:44-66)."""
    from scipy.optimize import linear_sum_assignment

    if all_res_masks.shape[0] < all_gt_masks.shape[0]:
        pad = np.zeros(
            (all_gt_masks.shape[0] - all_res_masks.shape[0], *all_res_masks.shape[1:])
        )
        all_res_masks = np.concatenate([all_res_masks, pad], 0)
    n_prop, n_obj = all_res_masks.shape[0], all_gt_masks.shape[0]
    T = all_gt_masks.shape[1]
    j = np.zeros((n_prop, n_obj, T))
    f = np.zeros((n_prop, n_obj, T))
    for ii in range(n_obj):
        for jj in range(n_prop):
            if "J" in metric:
                j[jj, ii] = db_eval_iou(all_gt_masks[ii], all_res_masks[jj])
            if "F" in metric:
                f[jj, ii] = db_eval_boundary(all_gt_masks[ii], all_res_masks[jj])
    if "J" in metric and "F" in metric:
        score = (j.mean(2) + f.mean(2)) / 2
    else:
        score = j.mean(2) if "J" in metric else f.mean(2)
    row, col = linear_sum_assignment(-score)
    return j[row, col], f[row, col]


def evaluate_sequences(
    sequences: Dict[str, Tuple[np.ndarray, np.ndarray]],
    task: str = "unsupervised",
) -> Dict[str, Dict[str, float]]:
    """sequences: name -> (gt (n_obj, T, H, W), res (n_prop, T, H, W)).
    Returns global J&F statistics like eval_davis.py's CSV tables."""
    res = {"J": {"M": [], "R": [], "D": []}, "F": {"M": [], "R": [], "D": []}}
    per_obj = {}
    for name, (gt, pred) in sequences.items():
        if task == "unsupervised":
            j, f = evaluate_unsupervised(gt, pred)
        else:
            gt = gt[:, 1:-1]
            pred = pred[: gt.shape[0], 1:-1] if pred.shape[0] >= gt.shape[0] else \
                np.concatenate([pred, np.zeros((gt.shape[0] - pred.shape[0],) + pred.shape[1:])])[:, 1:-1]
            j = np.stack([db_eval_iou(gt[i], pred[i]) for i in range(gt.shape[0])])
            f = np.stack([db_eval_boundary(gt[i], pred[i]) for i in range(gt.shape[0])])
        for ii in range(gt.shape[0]):
            jm, jr, jd = db_statistics(j[ii])
            fm, fr, fd = db_statistics(f[ii])
            res["J"]["M"].append(jm); res["J"]["R"].append(jr); res["J"]["D"].append(jd)
            res["F"]["M"].append(fm); res["F"]["R"].append(fr); res["F"]["D"].append(fd)
            per_obj[f"{name}_{ii + 1}"] = (jm, fm)

    out = {
        "J&F-Mean": float((np.mean(res["J"]["M"]) + np.mean(res["F"]["M"])) / 2),
        "J-Mean": float(np.mean(res["J"]["M"])),
        "J-Recall": float(np.mean(res["J"]["R"])),
        "J-Decay": float(np.mean(res["J"]["D"])),
        "F-Mean": float(np.mean(res["F"]["M"])),
        "F-Recall": float(np.mean(res["F"]["R"])),
        "F-Decay": float(np.mean(res["F"]["D"])),
    }
    return {"global": out, "per_object": per_obj}
