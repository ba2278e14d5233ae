"""Each rank's share of an epoch (counterpart of achelous_tpu/data/sampler.py;
reference train.py:576-580).

Every rank draws the same permutation, `np.random.RandomState(seed +
epoch).permutation(n)`, so no message is needed to agree on it; the list is
padded by wrapping to a multiple of the ranks (or truncated with
`drop_last`), and rank r takes `indices[r::num_replicas]`, the interleaved
split.  These are the JAX package's indices for every (n, replicas, rank,
shuffle, drop_last, seed, epoch); torch's own `DistributedSampler` draws
its permutations with `torch.randperm` and so gives others.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist


class DistributedSampler:
    """Deterministic per-rank epoch index shards.  `num_replicas` and
    `rank` default to the initialised process group's size and this
    process's rank, and to 1 and 0 without one."""

    def __init__(self, n: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        grouped = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if grouped else 1
        if rank is None:
            rank = dist.get_rank() if grouped else 0
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if drop_last:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = -(-n // num_replicas)   # ceil
        self.total_size = self.num_samples * num_replicas

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This rank's dataset indices for one epoch ([num_samples])."""
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(self.n)
        else:
            idx = np.arange(self.n)
        if self.drop_last:
            idx = idx[:self.total_size]
        elif len(idx) < self.total_size:           # pad by wrapping
            reps = -(-self.total_size // len(idx))
            idx = np.tile(idx, reps)[:self.total_size]
        return idx[self.rank::self.num_replicas]
