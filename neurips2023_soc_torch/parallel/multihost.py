"""Multi-process coordination on torch.distributed (the port's counterpart
of neurips2023_soc_tpu/parallel/multihost.py). In a single process every
helper is a no-op (gather_objects and broadcast_object are the identity).
"""
from __future__ import annotations

import os
from typing import Any, List, Tuple

import torch
import torch.distributed as dist


def _setting(env_key: str, config, config_key: str):
    value = os.environ.get(env_key)
    if value is None and config is not None:
        value = config.get(config_key)
    return value


def initialize_distributed(config=None) -> bool:
    """Starts the process group when the run has more than one process, as
    the standard environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK) or the config keys that the JAX package reads
    (coordinator_address "host:port", num_processes, process_id) say. NCCL
    on the card, gloo on the CPU; with LOCAL_RANK set, that card becomes the
    current device. Returns True when a group is running; a single process
    (no setting, or a world of 1) does nothing and returns False."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = _setting("WORLD_SIZE", config, "num_processes")
    if world is None or int(world) <= 1:
        return False
    rank = _setting("RANK", config, "process_id")
    if rank is None:
        raise ValueError("a multi-process run needs its rank (RANK or process_id)")
    if os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    elif config is not None and config.get("coordinator_address"):
        init_method = f"tcp://{config.get('coordinator_address')}"
    else:
        raise ValueError("a multi-process run needs MASTER_ADDR/MASTER_PORT or "
                         "coordinator_address")
    cuda = torch.cuda.is_available()
    local = os.environ.get("LOCAL_RANK")
    if cuda and local is not None:
        torch.cuda.set_device(int(local))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=int(world), rank=int(rank))
    print(f"torch.distributed initialized: rank {dist.get_rank()}/{dist.get_world_size()}")
    return True


def process_index_and_count() -> Tuple[int, int]:
    """(rank, world size) of the running process group; (0, 1) in a single
    process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier(name: str = "barrier") -> None:
    """dist.barrier across every process; `name` labels the call site."""
    if _group_running():
        dist.barrier()


def _group_running() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable `obj`, in rank order (reference misc.py:24-64
    all_gather): torch.distributed.all_gather_object when a process group is
    running, [obj] in a single process."""
    if not _group_running():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """Rank `root`'s picklable `obj` on every process (the reference's
    output-dir sync, trainer.py:118-122); `obj` itself in a single process."""
    if not _group_running():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]
