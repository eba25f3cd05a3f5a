"""ZeRO-1 optimizer-state sharding for `optimizer_sharding: zero1` (the
port's counterpart of neurips2023_soc_tpu/parallel/zero.py).

Each rank keeps the whole model and every gradient (DDP's all-reduce, as in
the replicated layout), but AdamW's moments only for its own partition of
the parameters: torch.distributed.optim.ZeroRedundancyOptimizer runs AdamW
on that partition and broadcasts the updated parameters to the other ranks.

The JAX module shards one axis of every optimizer-state leaf over the mesh
(`zero1_sharding_for`, pinned by `zero1_constrain` / `replicate_constrain`
inside the jitted step); ZeRO partitions whole parameters between the ranks
instead. Both give the same update in another layout, so those helpers have
no counterpart here, as `parallel/mesh.py` has none (DDP takes its place).
The clip, the lr schedule and the accumulation stay in
training/optim.py:Optimizer, which drives either AdamW. Its accumulator of
micro-step gradients stays whole on every rank, where the JAX layout shards
it too.

A checkpoint holds the whole optimizer state: `consolidate_state_dict` is a
collective every rank runs before rank 0 saves, and every rank loads the
whole dict back, each keeping its own partition.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

# torch.distributed.optim is imported where it is used: it adds about 1.5 s
# to every import of the package otherwise


def zero1_adamw(param_groups: List[Dict], **adamw_kwargs):
    """A ZeroRedundancyOptimizer running AdamW over `param_groups` (dicts
    with 'params', 'lr' and any extra keys), sharded over the running
    process group. Setting a group's 'lr' on the returned optimizer's
    `param_groups` reaches every rank's partition at its next step."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(param_groups, optimizer_class=torch.optim.AdamW,
                                   **adamw_kwargs)


def consolidate_state_dict(optimizer) -> None:
    """ZeroRedundancyOptimizer.consolidate_state_dict(to=0) through one
    gather of every rank's partition to rank 0, after which rank 0's
    `optimizer.state_dict()` holds the whole state. torch's own sends each
    rank's state as torch.ByteTensor(bytearray), built byte by byte: 0.14 s
    per MB on the CPU, 12 s for the tiny config's state of one rank."""
    from torch.distributed.optim.zero_redundancy_optimizer import _recursive_copy_to_device

    optimizer._sync_param_groups(optimizer.param_groups, optimizer.optim.param_groups)
    local = _recursive_copy_to_device(optimizer.optim.state_dict(), non_blocking=False,
                                      device=torch.device("cpu"))
    main = dist.get_rank() == 0
    states = [None] * dist.get_world_size() if main else None
    dist.gather_object(local, states, dst=0)
    if main:
        optimizer._all_state_dicts = states


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def opt_state_bytes_per_rank(optimizer) -> int:
    """Bytes of optimizer state this rank holds for a training/optim.py
    Optimizer: AdamW's moments and step counts of the rank's partition (of
    every parameter when replicated), plus the gradient accumulator when
    `grad_accum_steps` > 1 (whole on every rank). The counterpart of the JAX
    package's `opt_state_bytes_per_device`."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    inner = optimizer.adamw
    local = inner.optim if isinstance(inner, ZeroRedundancyOptimizer) else inner
    held = _tensor_bytes(v for state in local.state.values() for v in state.values())
    acc = (optimizer.acc or []) + [a for a in optimizer.frozen_acc if a is not None]
    return held + _tensor_bytes(acc)
