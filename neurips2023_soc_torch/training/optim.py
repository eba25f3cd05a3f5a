"""Optimizer with the JAX package's optax semantics
(neurips2023_soc_tpu/training/optim.py), in plain PyTorch:

    optax.chain(clip_by_global_norm(clip_max_norm),
                multi_transform({main, backbone, text: adamw(MultiStepLR),
                                 frozen: set_to_zero}))
    wrapped in optax.MultiSteps when grad_accum_steps > 1.

Groups by state_dict name: `backbone.*` -> lr_backbone, `text_encoder.*` ->
text_encoder_lr (or frozen when freeze_text), the rest -> lr. A frozen
parameter gets neither an update nor weight decay. AdamW is torch.optim.AdamW
(b1 0.9, b2 0.999, eps 1e-8; weight decay decoupled and scaled by the
scheduled lr, as optax.adamw). Where optax sees a zero gradient (a parameter
the loss does not reach), the port hands AdamW zeros too, so its moments
decay and its weight decay applies as in optax. The lr of update u (0-based,
counted in updates) is base * gamma ** #{m in milestones: u >= m}
(optax.piecewise_constant_schedule). The global norm that clips runs over
every gradient, the frozen ones included; a frozen text encoder's is zero
(SOC detaches its outputs, as JAX's stop_gradient does), so the port keeps
no accumulator for the frozen group.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch


def param_label(name: str, freeze_text: bool) -> str:
    if name.startswith("backbone."):
        return "backbone"
    if name.startswith("text_encoder."):
        return "frozen" if freeze_text else "text"
    return "main"


def update_milestones_from_microsteps(milestones_steps: Sequence[int],
                                      grad_accum_steps: int) -> List[int]:
    """Micro-step lr milestones in optimizer-update units. Floor division can
    collide two milestones or floor one to 0; every drop is kept by clamping
    to >= 1 and forcing a strict increase."""
    k = max(1, int(grad_accum_steps))
    out: List[int] = []
    for m in milestones_steps:
        u = max(1, int(m) // k)
        if out and u <= out[-1]:
            u = out[-1] + 1
        out.append(u)
    return out


def multistep_lr(base_lr: float, milestones_steps: Sequence[int], gamma: float,
                 count: int) -> float:
    """optax.piecewise_constant_schedule(base, {m: gamma}) at update `count`."""
    lr = base_lr
    for m in sorted(int(m) for m in milestones_steps):
        if count >= m:
            lr = lr * gamma
    return lr


def global_norm(grads: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (None counts as zero),
    in float32, as a tensor on the gradients' device (no host read)."""
    gs = [g for g in grads if g is not None]
    if not gs:
        return torch.zeros(())
    norms = torch._foreach_norm([g.float() for g in gs])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Clipped three-group AdamW with optax's semantics over a model's named
    parameters. `apply_gradients()` consumes the parameters' `.grad` (set by
    backward), updates the parameters in place and clears the gradients."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: float, lr_backbone: float, text_encoder_lr: float,
                 weight_decay: float = 1e-4, clip_max_norm: float = 0.1,
                 milestones_steps: Sequence[int] = (), gamma: float = 0.1,
                 freeze_text: bool = True, grad_accum_steps: int = 1):
        self.params: Dict[str, torch.nn.Parameter] = dict(named_params)
        self.labels = {n: param_label(n, freeze_text) for n in self.params}
        self.base_lr = {"main": lr, "backbone": lr_backbone, "text": text_encoder_lr}
        self.clip_max_norm = float(clip_max_norm or 0.0)
        self.milestones_steps = [int(m) for m in milestones_steps]
        self.gamma = gamma
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.trainable = [p for n, p in self.params.items() if self.labels[n] != "frozen"]
        groups = []
        for label in ("main", "backbone", "text"):
            ps = [p for n, p in self.params.items() if self.labels[n] == label]
            if ps:
                groups.append({"params": ps, "lr": self.base_lr[label], "label": label})
        self.adamw = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0  # optimizer updates applied
        self.mini_step = 0  # micro-batches accumulated towards the next update
        self.acc: Optional[List[torch.Tensor]] = None  # running mean of micro-grads

    def lr(self, label: str = "main") -> float:
        """The lr the next update applies to a group."""
        return multistep_lr(self.base_lr[label], self.milestones_steps, self.gamma,
                            self.count)

    def apply_gradients(self) -> bool:
        """One micro-step. Returns True when it applied an update (every
        grad_accum_steps-th call), False while accumulating."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.trainable]
        frozen = [p.grad for n, p in self.params.items()
                  if self.labels[n] == "frozen" and p.grad is not None]
        k = self.grad_accum_steps
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.trainable]
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            self.zero_grad()
            if self.mini_step < k:
                return False
            grads, self.mini_step, frozen = [a.clone() for a in self.acc], 0, []
            for a in self.acc:
                a.zero_()
        if self.clip_max_norm > 0:
            norm = global_norm(grads + frozen)
            scale = torch.where(norm < self.clip_max_norm, torch.ones_like(norm),
                                self.clip_max_norm / norm)
            torch._foreach_mul_(grads, scale)
        for p, g in zip(self.trainable, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(group["label"])
        self.adamw.step()
        self.count += 1
        self.zero_grad()
        return True

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.trainable)]


def build_optimizer(model: torch.nn.Module, lr: float, lr_backbone: float,
                    text_encoder_lr: float, weight_decay: float = 1e-4,
                    clip_max_norm: float = 0.1, milestones_steps: Sequence[int] = (),
                    gamma: float = 0.1, freeze_text: bool = True,
                    grad_accum_steps: int = 1) -> Optimizer:
    """`milestones_steps` in optimizer-update units (the trainer converts
    micro-step milestones with update_milestones_from_microsteps)."""
    return Optimizer(model.named_parameters(), lr, lr_backbone, text_encoder_lr,
                     weight_decay, clip_max_norm, milestones_steps, gamma, freeze_text,
                     grad_accum_steps)
