"""Torch-exact image resizing on channels-last tensors, as gathers.

The same index math as neurips2023_soc_tpu/ops/resize.py (which reproduces
`F.interpolate` there), kept channels-last so the port's layouts match the
JAX package's: (..., H, W, C). Index vectors are built on the tensor's device,
so no host data is uploaded.
"""
from __future__ import annotations

import torch


def _out_coords_nearest(out_size: int, in_size: int, device) -> torch.Tensor:
    # torch 'nearest': src = floor(dst * in / out)
    idx = torch.arange(out_size, dtype=torch.float32, device=device) * (in_size / out_size)
    return idx.long().clamp(0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') on (..., H, W, C) -> (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    x = x.index_select(-3, _out_coords_nearest(out_h, h, x.device))
    return x.index_select(-2, _out_coords_nearest(out_w, w, x.device))


def _src_index_weight(out_size: int, in_size: int, align_corners: bool, device):
    """Source sample positions for 1-D linear interpolation, torch semantics."""
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            src = torch.zeros_like(dst)
        else:
            src = dst * ((in_size - 1) / (out_size - 1))
    else:
        src = ((dst + 0.5) * (in_size / out_size) - 0.5).clamp(min=0.0)
    i0 = torch.floor(src).long().clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(max=in_size - 1)
    return i0, i1, src - i0.float()


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear') on (..., H, W, C), computed in float32
    and cast back to the input dtype."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    xf = x.float()
    y0, y1, fy = _src_index_weight(out_h, h, align_corners, x.device)
    x0, x1, fx = _src_index_weight(out_w, w, align_corners, x.device)
    fy = fy.view(out_h, 1, 1)
    rows = xf.index_select(-3, y0) * (1.0 - fy) + xf.index_select(-3, y1) * fy
    fx = fx.view(out_w, 1)
    out = rows.index_select(-2, x0) * (1.0 - fx) + rows.index_select(-2, x1) * fx
    return out.to(x.dtype)


def _edge_pad(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """Replicate the first/last entry along `dim` (jnp.pad mode='edge')."""
    parts = [x.narrow(dim, 0, 1).repeat_interleave(before, dim)] if before else []
    parts.append(x)
    if after:
        parts.append(x.narrow(dim, x.shape[dim] - 1, 1).repeat_interleave(after, dim))
    return torch.cat(parts, dim)


def aligned_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """CondInst's aligned upsample on (..., H, W, C): replicate-pad
    bottom/right by 1, bilinear-resize (align_corners=True) to
    (f*H+1, f*W+1), replicate-pad top/left by f//2, crop to (f*H, f*W)."""
    if factor < 1 or int(factor) != factor:
        raise ValueError(f"factor must be a positive integer, got {factor}")
    if factor == 1:
        return x
    h, w = x.shape[-3], x.shape[-2]
    x = _edge_pad(_edge_pad(x, x.dim() - 3, 0, 1), x.dim() - 2, 0, 1)
    oh, ow = factor * h + 1, factor * w + 1
    x = resize_bilinear(x, oh, ow, align_corners=True)
    k = factor // 2
    x = _edge_pad(_edge_pad(x, x.dim() - 3, k, 0), x.dim() - 2, k, 0)
    return x[..., : oh - 1, : ow - 1, :]


def downsample_mask_nearest(mask: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resampling of a (..., H, W) bool pad mask, the reference's
    `F.interpolate(mask[None].float(), size).to(bool)`."""
    return resize_nearest(mask[..., None], out_h, out_w)[..., 0]
