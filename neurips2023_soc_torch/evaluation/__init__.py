from . import rle
from .coco_eval import evaluate_coco_map, precision_at_k_and_iou
from .davis import (db_eval_boundary, db_eval_iou, db_statistics, evaluate_sequences,
                    evaluate_unsupervised)
from .refexp_eval import bbox_precision_at_k_and_iou, evaluate_refexp_recall

__all__ = [
    "bbox_precision_at_k_and_iou",
    "db_eval_boundary",
    "db_eval_iou",
    "db_statistics",
    "evaluate_coco_map",
    "evaluate_refexp_recall",
    "evaluate_sequences",
    "evaluate_unsupervised",
    "precision_at_k_and_iou",
    "rle",
]
