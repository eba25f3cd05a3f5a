"""The train step (torch twin of neurips2023_soc_tpu/training/train_step.py):
forward in training mode -> criterion with on-device matching -> backward
-> clipped three-group AdamW.

JAX returns a new state from a jitted pure function; the port updates the
parameters and optimizer state in place (no second copy of either) and
returns the same state object. Dropout and drop-path masks come from one
torch.Generator on the model's device, reseeded from `seed` every step (the
counterpart of `rngs={"dropout": rng}`). Metrics stay tensors on the device:
reading them is the caller's choice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..losses import CriterionConfig, compute_criterion, total_loss
from .optim import Optimizer, global_norm

TARGET_KEYS = (
    "masks", "boxes", "labels", "inst_valid", "is_ref_inst_visible",
    "referred_instance_idx",
)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0  # micro-steps taken (JAX TrainState.step)


def device_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The array entries of a collated batch as tensors on `device`; host
    metadata (strings, tuples, lists) is dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) or hasattr(v, "ndim"):
            out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


def make_train_step(model: torch.nn.Module, crit_cfg: CriterionConfig,
                    has_valid_indices: bool = False):
    """Returns step(state, batch, seed) -> (state, metrics); metrics hold
    `loss`, every loss term and `grad_norm` (the global norm of the
    micro-batch's gradients, before clipping), as tensors."""
    device = next(model.parameters()).device
    rng = torch.Generator(device=device)

    def step(state: TrainState, batch: Dict[str, Any],
             seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        b = device_batch(batch, device)
        rng.manual_seed(int(seed))
        out = state.model(
            b["pixels"], b["pad_mask"], b["text_ids"], b["text_mask"],
            sample_sizes=b.get("sample_sizes"),
            valid_indices=b.get("valid_indices") if has_valid_indices else None,
            training=True, rng=rng)
        losses = compute_criterion(out, {k: b[k] for k in TARGET_KEYS}, crit_cfg)
        loss = total_loss(losses, crit_cfg)
        loss.backward()
        grad_norm = global_norm(p.grad for p in state.model.parameters())
        state.optimizer.apply_gradients()
        state.step += 1
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()},
                   "grad_norm": grad_norm}
        return state, metrics

    return step
