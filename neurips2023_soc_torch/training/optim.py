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
every gradient, the frozen ones included, as optax.clip_by_global_norm runs
before set_to_zero: the ResNet backbone's FrozenBN tensors (models/resnet.py;
label `frozen`, as JAX's `frozen_bn` params) get gradients that enter the
norm and never an update. A frozen text encoder gets no gradient (SOC
detaches its outputs, as JAX's stop_gradient does, where its gradient is
zero), so the port keeps no accumulator for it.

`zero1=True` (`optimizer_sharding: zero1`) runs AdamW as ZeRO-1
(parallel/zero.py) when a process group runs; the clip, the schedule and
the accumulation stay here. In a single process it is the plain AdamW.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..parallel.multihost import distributed, is_main_process

# the FrozenBN tensors of the ResNet backbone under the reference's
# torchvision keys: bn1, layer{s}.{i}.bn{1,2,3} and layer{s}.{i}.downsample.1
_FROZEN_BN = re.compile(
    r"^backbone\.0\.body\.(.*\.)?(bn\d|downsample\.1)\.(weight|bias|running_mean|running_var)$")


def param_label(name: str, freeze_text: bool) -> str:
    if _FROZEN_BN.match(name):
        return "frozen"
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
                 freeze_text: bool = True, grad_accum_steps: int = 1, zero1: bool = False):
        self.params: Dict[str, torch.nn.Parameter] = dict(named_params)
        self.labels = {n: param_label(n, freeze_text) for n in self.params}
        self.base_lr = {"main": lr, "backbone": lr_backbone, "text": text_encoder_lr}
        self.clip_max_norm = float(clip_max_norm or 0.0)
        self.milestones_steps = [int(m) for m in milestones_steps]
        self.gamma = gamma
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.trainable = [p for n, p in self.params.items() if self.labels[n] != "frozen"]
        self.frozen = [p for n, p in self.params.items() if self.labels[n] == "frozen"]
        groups = []
        for label in ("main", "backbone", "text"):
            ps = [p for n, p in self.params.items() if self.labels[n] == label]
            if ps:
                groups.append({"params": ps, "lr": self.base_lr[label], "label": label})
        adamw_kwargs = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.zero1 = bool(zero1) and distributed()
        if self.zero1:
            from ..parallel.zero import zero1_adamw

            self.adamw = zero1_adamw(groups, **adamw_kwargs)
        else:
            self.adamw = torch.optim.AdamW(groups, **adamw_kwargs)
        self.count = 0  # optimizer updates applied
        self.mini_step = 0  # micro-batches accumulated towards the next update
        # running means of the micro-grads (whole on every rank, also under
        # ZeRO-1): `acc` of the trainable tensors, `frozen_acc` of the frozen
        # ones the loss reaches, made at their first gradient
        self.acc: Optional[List[torch.Tensor]] = None
        self.frozen_acc: List[Optional[torch.Tensor]] = [None] * len(self.frozen)

    def lr(self, label: str = "main") -> float:
        """The lr the next update applies to a group."""
        return multistep_lr(self.base_lr[label], self.milestones_steps, self.gamma,
                            self.count)

    def apply_gradients(self) -> bool:
        """One micro-step. Returns True when it applied an update (every
        grad_accum_steps-th call), False while accumulating."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.trainable]
        frozen = [p.grad for p in self.frozen]  # None where the loss does not reach
        k = self.grad_accum_steps
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.trainable]
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            for i, g in enumerate(frozen):
                if g is not None and self.frozen_acc[i] is None:
                    self.frozen_acc[i] = torch.zeros_like(g)
                a = self.frozen_acc[i]
                if a is not None:
                    a.add_((g - a) / (n + 1)) if g is not None else a.mul_(n / (n + 1))
            self.mini_step += 1
            self.zero_grad()
            if self.mini_step < k:
                return False
            grads, frozen = [a.clone() for a in self.acc], self.frozen_acc
            self.mini_step, self.frozen_acc = 0, [None] * len(self.frozen)
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

    def state_dict(self) -> Optional[Dict]:
        """Under ZeRO-1 a collective that every rank calls: the whole state
        on rank 0, None on the others."""
        if self.zero1:
            from ..parallel.zero import consolidate_state_dict

            consolidate_state_dict(self.adamw)
            if not is_main_process():
                return None
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc, "frozen_acc": self.frozen_acc}

    def load_state_dict(self, state: Dict) -> None:
        """The whole state (under ZeRO-1 every rank keeps its partition)."""
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.trainable)]
        frozen_acc = state.get("frozen_acc") or [None] * len(self.frozen)
        self.frozen_acc = [None if a is None else a.to(p.device)
                           for a, p in zip(frozen_acc, self.frozen)]


def build_optimizer(model: torch.nn.Module, lr: float, lr_backbone: float,
                    text_encoder_lr: float, weight_decay: float = 1e-4,
                    clip_max_norm: float = 0.1, milestones_steps: Sequence[int] = (),
                    gamma: float = 0.1, freeze_text: bool = True,
                    grad_accum_steps: int = 1, zero1: bool = False) -> Optimizer:
    """`milestones_steps` in optimizer-update units (the trainer converts
    micro-step milestones with update_milestones_from_microsteps)."""
    return Optimizer(model.named_parameters(), lr, lr_backbone, text_encoder_lr,
                     weight_decay, clip_max_norm, milestones_steps, gamma, freeze_text,
                     grad_accum_steps, zero1)
