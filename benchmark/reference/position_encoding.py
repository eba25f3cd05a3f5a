"""Sine positional encodings, pad-mask aware. Channels-last: 2D returns
(B, H, W, C), 1D returns (B, S, C)."""
from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """stack(sin(pos[..., 0::2]), cos(pos[..., 1::2])) flattened — torch order."""
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).flatten(-2)


def position_embedding_sine_1d(pad_mask: torch.Tensor, num_pos_feats: int = 256,
                               temperature: float = 10000.0,
                               normalize: bool = True) -> torch.Tensor:
    """pad_mask: (B, S) True on padding -> (B, S, num_pos_feats) float32."""
    x_embed = torch.cumsum((~pad_mask).float(), dim=1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    pos_x = x_embed[:, :, None] / _dim_t(num_pos_feats, temperature, pad_mask.device)
    return _interleave_sin_cos(pos_x)


def position_embedding_sine_2d(pad_mask: torch.Tensor, num_pos_feats: int = 128,
                               temperature: float = 10000.0,
                               normalize: bool = True) -> torch.Tensor:
    """pad_mask: (B, H, W) True on padding -> (B, H, W, 2*num_pos_feats)."""
    not_mask = (~pad_mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * (2 * math.pi)
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * (2 * math.pi)
    dim_t = _dim_t(num_pos_feats, temperature, pad_mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)
