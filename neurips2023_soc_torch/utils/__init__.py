from .boxes import (box_area, box_cxcywh_to_xyxy, box_iou, box_xyxy_to_cxcywh,
                    generalized_box_iou, inverse_sigmoid, masks_to_boxes)
from .padded import (DEFAULT_SIZE_BUCKETS, DEFAULT_TIME_BUCKETS, batch_videos,
                     eval_size_buckets, pad_instances, pick_size_bucket, pick_time_bucket,
                     train_size_buckets)

__all__ = [
    "box_area",
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "box_iou",
    "generalized_box_iou",
    "inverse_sigmoid",
    "masks_to_boxes",
    "DEFAULT_SIZE_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "batch_videos",
    "eval_size_buckets",
    "pad_instances",
    "pick_size_bucket",
    "pick_time_bucket",
    "train_size_buckets",
]
