from .boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh, inverse_sigmoid
from .padded import eval_size_buckets, pick_size_bucket, pick_time_bucket

__all__ = [
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "inverse_sigmoid",
    "eval_size_buckets",
    "pick_size_bucket",
    "pick_time_bucket",
]
