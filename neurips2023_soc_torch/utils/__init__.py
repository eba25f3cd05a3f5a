from .boxes import (box_cxcywh_to_xyxy, box_iou, box_xyxy_to_cxcywh, generalized_box_iou,
                    inverse_sigmoid)
from .padded import eval_size_buckets, pick_size_bucket, pick_time_bucket, train_size_buckets

__all__ = [
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "box_iou",
    "generalized_box_iou",
    "inverse_sigmoid",
    "eval_size_buckets",
    "pick_size_bucket",
    "pick_time_bucket",
    "train_size_buckets",
]
