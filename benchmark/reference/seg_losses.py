"""Mask losses (a frozen copy of the port's losses/segmentation.py)."""
from __future__ import annotations

from typing import Optional

import torch


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs/targets: (N, P) logits/binary. weight: (N,) 0/1 validity."""
    probs = torch.sigmoid(inputs.float().clamp(-30, 30))
    targets = targets.float()
    numerator = 2.0 * (probs * targets).sum(-1)
    denominator = probs.sum(-1) + targets.sum(-1)
    loss = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    if weight is not None:
        loss = loss * weight
    return loss.sum() / num_masks


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks,
                       alpha: float = 0.25, gamma: float = 2.0,
                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: (N, P) logits; mean over P, weighted sum over N, / num_masks."""
    x = inputs.float()
    t = targets.float()
    p = torch.sigmoid(x.clamp(-30, 30))
    ce = x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    loss = loss.mean(dim=tuple(range(1, loss.dim())))
    if weight is not None:
        loss = loss * weight
    return loss.sum() / num_masks
