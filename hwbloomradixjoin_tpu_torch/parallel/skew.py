"""Skew-aware repartitioning for the distributed shuffle.

Counterpart of ``hwbloomradixjoin_tpu/parallel/skew.py``.  The reference's
SKEW_HANDLING (parallel_radix_join_bloom.c:1175-1415) re-partitions
partitions past a threshold and splits the probe side of still-heavy ones
across threads that share one build side.  Here heavy keys (a Zipf probe
side) load one destination device: from the global destination histogram
(an all_reduce), a destination whose S load exceeds `factor` times the mean
is heavy; its S tuples are re-routed round-robin over every device and the
matching R tuples are replicated to every device (replicate-R/split-S).
Counts stay exact: every S tuple still meets each of its R partners once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def heavy_dest_mask(dest: torch.Tensor, n_dev: int, group,
                    factor: float = 2.0, valid=None) -> torch.Tensor:
    """The global per-destination S-load histogram, all_reduced over the
    group, as a bool (n_dev,) mask of heavy destinations, the same on
    every rank.  Heavy: load > int(mean * factor) with mean = max(total //
    n_dev, 1), the product taken in float32 as the JAX package's int32
    times Python float is.  At n_dev = 2 no destination can pass it.
    """
    if valid is not None:
        dest = dest[valid]
    glob = torch.bincount(dest.long(), minlength=n_dev)[:n_dev]
    dist.all_reduce(glob, group=group)
    mean = max(int(glob.sum()) // n_dev, 1)
    return glob > int(np.float32(mean) * np.float32(factor))


def split_heavy_dests(dest: torch.Tensor, heavy: torch.Tensor, n_dev: int,
                      salt: torch.Tensor) -> torch.Tensor:
    """Re-route tuples bound for heavy destinations round-robin by `salt`
    (a non-negative int a tuple); the other destinations stay."""
    spread = (salt % n_dev).to(torch.int32)
    return torch.where(heavy[dest.long()], spread, dest)


def replicate_mask_for_r(dest: torch.Tensor, heavy: torch.Tensor):
    """R tuples bound for a heavy destination go to every device."""
    return heavy[dest.long()]
