"""Multi-scale deformable attention, plain PyTorch: a frozen copy of the
port's `ms_deform_attn_torch` (direct 4-corner bilinear sampling with zero
padding, pixel coordinate x = loc_x * W - 0.5, sums in float32, the output in
the value's dtype). Autograd differentiates it.

Shapes: value (B, S, M, D), sampling_locations (B, Lq, M, L, P, 2) float32,
attention_weights (B, Lq, M, L, P); returns (B, Lq, M * D).
"""
from __future__ import annotations

from typing import Tuple

import torch

SpatialShapes = Tuple[Tuple[int, int], ...]


def level_start_index(spatial_shapes: SpatialShapes) -> Tuple[int, ...]:
    starts, cur = [], 0
    for h, w in spatial_shapes:
        starts.append(cur)
        cur += h * w
    return tuple(starts)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: direct 4-corner bilinear sampling with zero
    padding, accumulated in float32."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in the locations, {len(spatial_shapes)} shapes")
    starts = level_start_index(spatial_shapes)
    loc = sampling_locations.float()
    attn = attention_weights.float()
    vh = value.float().permute(0, 2, 1, 3)  # (B, M, S, D)
    out = torch.zeros(B, M, Lq, D, dtype=torch.float32, device=value.device)
    for l, (H, W) in enumerate(spatial_shapes):
        x = loc[:, :, :, l, :, 0] * W - 0.5  # (B, Lq, M, P)
        y = loc[:, :, :, l, :, 1] * H - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx, fy = x - x0, y - y0
        a = attn[:, :, :, l]
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xi = x0 + dx
                yi = y0 + dy
                inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                w = torch.where(inside, wy * wx * a, torch.zeros_like(a))
                idx = (starts[l] + yi.clamp(0, H - 1) * W
                       + xi.clamp(0, W - 1)).long()
                idx = idx.permute(0, 2, 1, 3).reshape(B, M, Lq * P, 1)
                g = torch.gather(vh, 2, idx.expand(B, M, Lq * P, D))
                g = g.view(B, M, Lq, P, D)
                out += (g * w.permute(0, 2, 1, 3)[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)
