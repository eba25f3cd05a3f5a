from .ms_deform_attn import level_start_index, ms_deform_attn, ms_deform_attn_torch
from .resize import (
    aligned_bilinear,
    downsample_mask_nearest,
    resize_bilinear,
    resize_nearest,
)

__all__ = [
    "ms_deform_attn",
    "ms_deform_attn_torch",
    "level_start_index",
    "aligned_bilinear",
    "resize_bilinear",
    "resize_nearest",
    "downsample_mask_nearest",
]
