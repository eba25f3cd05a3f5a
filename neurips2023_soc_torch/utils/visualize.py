"""Mask/box overlay visualization for the inference CLIs (the port's copy of
neurips2023_soc_tpu/utils/visualize.py; reference infer_refytb.py:240-266 +
vis_add_mask at 320-328, infer_davis.py:274-283).

All helpers are pure numpy on uint8 RGB frames; PIL is used only for IO by
the callers. One deliberate deviation: for DAVIS merged index masks the
reference colors ALL objects with the color of the last object index (the
`i` leftover from the object loop, infer_davis.py:279); here each object id
gets its own palette color.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .colormap import colormap


def vis_add_mask(frame_u8: np.ndarray, mask: np.ndarray,
                 color: Sequence[float], alpha: float = 0.5) -> np.ndarray:
    """Blend `color` into `frame_u8` where mask > 0.5
    (reference infer_refytb.py:320-328: fixed 0.5/0.5 blend)."""
    out = frame_u8.astype(np.float32).copy()
    m = np.asarray(mask) > 0.5
    out[m] = out[m] * (1.0 - alpha) + np.asarray(color, np.float32) * alpha
    return out.astype(np.uint8)


def vis_add_index_mask(frame_u8: np.ndarray, index_mask: np.ndarray,
                       alpha: float = 0.5) -> np.ndarray:
    """Overlay a merged DAVIS index mask (0 = background, k = object k),
    one palette color per object id."""
    out = frame_u8.astype(np.float32).copy()
    colors = colormap(rgb=True)
    for obj in np.unique(index_mask):
        if obj == 0:
            continue
        m = index_mask == obj
        out[m] = (out[m] * (1.0 - alpha)
                  + colors[(int(obj) - 1) % len(colors)] * alpha)
    return out.astype(np.uint8)


def draw_box(frame_u8: np.ndarray, box_xyxy: Sequence[float],
             color: Sequence[float], width: int = 2) -> np.ndarray:
    """Rectangle outline (reference draws via PIL ImageDraw.rectangle with
    width=2, infer_refytb.py:251)."""
    out = frame_u8.copy()
    h, w = out.shape[:2]
    x1, y1, x2, y2 = [int(round(float(v))) for v in box_xyxy]
    x1, x2 = sorted((max(0, min(w - 1, x1)), max(0, min(w - 1, x2))))
    y1, y2 = sorted((max(0, min(h - 1, y1)), max(0, min(h - 1, y2))))
    c = np.asarray(color, out.dtype)
    for k in range(width):
        t, b = min(y1 + k, h - 1), max(y2 - k, 0)
        l, r = min(x1 + k, w - 1), max(x2 - k, 0)
        out[t, x1 : x2 + 1] = c
        out[b, x1 : x2 + 1] = c
        out[y1 : y2 + 1, l] = c
        out[y1 : y2 + 1, r] = c
    return out


def overlay_prediction(frame_u8: np.ndarray, mask: np.ndarray,
                       box_xyxy: Optional[Sequence[float]],
                       color_index: int) -> np.ndarray:
    """Box + mask overlay with the expression's palette color
    (reference infer_refytb.py:245-258: rectangle then vis_add_mask,
    color_list[i % len(color_list)] in RGB order)."""
    colors = colormap(rgb=True)
    color = colors[int(color_index) % len(colors)]
    out = frame_u8
    if box_xyxy is not None:
        out = draw_box(out, box_xyxy, color)
    return vis_add_mask(out, mask, color)
