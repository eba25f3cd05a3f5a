"""Multi-process coordination on torch.distributed (the port's counterpart
of neurips2023_soc_tpu/parallel/multihost.py; its `parallel/mesh.py` becomes
DistributedDataParallel, one process per rank, in training/trainer.py). In a
single process, with no group running, every helper is a no-op:
gather_objects, broadcast_object and the all-reduces are the identity.
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


def dist_backend(config=None) -> str:
    """The process group's backend: DIST_BACKEND, else the config's
    `dist_backend`, else NCCL on the card and gloo on the CPU. NCCL refuses
    two ranks on one card, so ranks that share a card must ask for gloo by
    name; nothing falls back to another backend."""
    backend = _setting("DIST_BACKEND", config, "dist_backend")
    if backend:
        backend = str(backend).lower()
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"dist_backend must be nccl or gloo, not {backend}")
        return backend
    return "nccl" if torch.cuda.is_available() else "gloo"


def _set_rank_device(local_rank: int, backend: str) -> None:
    """LOCAL_RANK's card becomes the current device; more ranks than cards
    share them round robin only on gloo."""
    cards = torch.cuda.device_count()
    if local_rank >= cards and backend != "gloo":
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} on {cards} card(s): NCCL takes one rank per card; "
            "ranks share a card only on gloo (dist_backend: gloo or DIST_BACKEND=gloo)")
    torch.cuda.set_device(local_rank % cards)


def initialize_distributed(config=None) -> bool:
    """Starts the process group when the run has more than one process, as
    the standard environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK) or the config keys that the JAX package reads
    (coordinator_address "host:port", num_processes, process_id) say, on
    `dist_backend(config)`. On the card, LOCAL_RANK's card becomes the
    current device. Returns True when a group is running; a single process
    (no setting, or a world of 1) does nothing and returns False."""
    if distributed():
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
    backend = dist_backend(config)
    local = os.environ.get("LOCAL_RANK")
    if torch.cuda.is_available() and local is not None:
        _set_rank_device(int(local), backend)
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank))
    print(f"torch.distributed initialized: rank {dist.get_rank()}/{dist.get_world_size()} "
          f"on {backend}")
    return True


def distributed() -> bool:
    """True while a torch.distributed process group runs (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_index_and_count() -> Tuple[int, int]:
    """(rank, world size) of the running process group; (0, 1) in a single
    process."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return process_index_and_count()[1]


def is_main_process() -> bool:
    return process_index_and_count()[0] == 0


def barrier(name: str = "barrier") -> None:
    """dist.barrier across every process; `name` labels the call site."""
    if distributed():
        dist.barrier()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, as a new tensor (no gradient); `x`
    itself in a single process."""
    if not distributed():
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks (no gradient); `x` in a single process."""
    if not distributed():
        return x
    return all_reduce_sum(x) / world_size()


def gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable `obj`, in rank order (reference misc.py:24-64
    all_gather): torch.distributed.all_gather_object when a process group is
    running, [obj] in a single process."""
    if not distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """Rank `root`'s picklable `obj` on every process (the reference's
    output-dir sync, trainer.py:118-122); `obj` itself in a single process."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]
