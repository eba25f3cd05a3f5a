"""Box conversions, IoU / GIoU, inverse_sigmoid and masks_to_boxes (torch
twins of neurips2023_soc_tpu/utils/boxes.py)."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU and union. boxes1: (..., N, 4), boxes2: (..., M, 4), xyxy."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes, (..., N, M). No assertion on degenerate
    boxes, as in the JAX package: callers mask invalid entries."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) binary masks -> (..., 4) xyxy float32 boxes in pixels, the
    last pixel inclusive; zeros for an empty mask."""
    h, w = masks.shape[-2:]
    m = masks.float()
    ys = torch.arange(h, dtype=torch.float32, device=m.device)
    xs = torch.arange(w, dtype=torch.float32, device=m.device)
    x_proj, y_proj = m.amax(-2), m.amax(-1)  # (..., W), (..., H)
    big = torch.tensor(1e8, dtype=torch.float32, device=m.device)
    boxes = torch.stack([torch.where(x_proj > 0, xs, big).amin(-1),
                         torch.where(y_proj > 0, ys, big).amin(-1),
                         (x_proj * xs).amax(-1), (y_proj * ys).amax(-1)], -1)
    return torch.where((m.sum((-1, -2)) > 0)[..., None], boxes, torch.zeros_like(boxes))
