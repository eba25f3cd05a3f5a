"""Swin window attention, plain PyTorch: a frozen copy of the port's
`window_attention_torch` and `mask_from_ids`."""
from __future__ import annotations

from typing import Optional

import torch


def mask_from_ids(ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(nW, N) int region labels -> (nW, N, N) additive 0 / -100 mask."""
    neq = ids[:, None, :] != ids[:, :, None]
    return torch.where(neq, -100.0, 0.0).to(dtype)


def window_attention_torch(
    q: torch.Tensor,  # (B_, H, N, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (H, N, N)
    mask: Optional[torch.Tensor] = None,  # (nW, N, N) additive; B_ % nW == 0
) -> torch.Tensor:
    B_, H, N, Dh = q.shape
    attn = (q * Dh ** -0.5) @ k.transpose(-2, -1)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, H, N, N) + mask[None, :, None].to(attn.dtype)
        attn = attn.view(B_, H, N, N)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return attn @ v
