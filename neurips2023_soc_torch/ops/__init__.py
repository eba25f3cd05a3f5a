from .layer_norm import layer_norm, layer_norm_ref
from .ms_deform_attn import level_start_index, ms_deform_attn, ms_deform_attn_torch
from .resize import (
    aligned_bilinear,
    downsample_mask_nearest,
    resize_bilinear,
    resize_nearest,
)
from .window_attention import window_attention, window_attention_ref, window_attention_torch

__all__ = [
    "layer_norm",
    "layer_norm_ref",
    "window_attention",
    "window_attention_ref",
    "window_attention_torch",
    "ms_deform_attn",
    "ms_deform_attn_torch",
    "level_start_index",
    "aligned_bilinear",
    "resize_bilinear",
    "resize_nearest",
    "downsample_mask_nearest",
]
