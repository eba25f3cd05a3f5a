"""RefCOCO ground truth for the pretraining evaluator (the port's copy of the
parts of neurips2023_soc_tpu/data/coco_ref.py that evaluation needs). The
image-as-clip dataset itself comes with the training datasets. PIL is
imported where polygons are rasterized."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def polygons_to_mask(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    mask = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(mask)
    for poly in polygons:
        if len(poly) >= 6:
            draw.polygon(list(map(float, poly)), outline=1, fill=1)
    return np.asarray(mask, np.uint8)


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    from ..evaluation.rle import decode

    rle = dict(seg)
    rle.setdefault("size", [h, w])
    return decode(rle)


def build_refcoco_gt(dataset):
    """COCO-format GT straight from the val json annotations, in original
    image coordinates (predictions are mapped back to the original size by
    the postprocessor). `dataset` has `items` [(image_id, [ann, ...])] and
    `imgs` {image_id: {height, width}}. Returns (gt_annotations,
    gt_boxes_by_img) for evaluators.evaluate_coco_pretrain_batches."""
    from ..evaluation.rle import encode as rle_encode

    gt_annotations: List[Dict] = []
    gt_boxes_by_img: Dict = {}
    for image_id, anns in dataset.items:
        im = dataset.imgs[image_id]
        h, w = im["height"], im["width"]
        ann = anns[0]  # one referred instance per image in refexp jsons
        mask = ann_to_mask(ann, h, w)
        gt_annotations.append({
            "image_id": image_id,
            "segmentation": rle_encode(mask),
            "iscrowd": int(ann.get("iscrowd", 0)),
            "area": float(ann.get("area", int(mask.sum()))),
        })
        x, y, bw, bh = ann["bbox"]
        gt_boxes_by_img[image_id] = np.array([[x, y, x + bw, y + bh]], np.float32)
    return gt_annotations, gt_boxes_by_img
