"""Epoch-shuffled, per-process sharded sample order (the port's copy of
neurips2023_soc_tpu/data/sampler.py; reference datasets/sampler.py, the
Deformable-DETR DistributedSampler).

Every process computes the same permutation from the same seed and takes its
`host_id::num_hosts` stride, so the k-th local batches of all processes form
the k-th global batch. The caller passes the rank and world size
(torch.distributed's when a group is running, else 0 and 1).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ShardedEpochSampler:
    """torch's DistributedSampler with drop_last=False: the order is padded
    to a multiple of num_hosts by wrapping around."""

    def __init__(self, dataset_size: int, num_hosts: int = 1, host_id: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.dataset_size = dataset_size
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return (self.dataset_size + self.num_hosts - 1) // self.num_hosts

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        total = len(self) * self.num_hosts
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        return iter(order[self.host_id:: self.num_hosts].tolist())
