"""Radix clustering and sorting as standalone operators.

Counterpart of ``hwbloomradixjoin_tpu/ops/sort.py``.  The reference's
radix-clustering pass is an MSB radix-sort pass (radix_cluster,
parallel_radix_join.c:570); exposed here over (key, payload) columns:

- ``radix_cluster``: one ``radix.partition_pass`` (kernel 1 on the card, its
  plain twin on the CPU) clusters the column into 2^bits bucket runs a chunk,
  with each chunk's start offsets: the operator the join engine's S pass
  runs, standalone (BASELINE operator set #10);
- ``radix_sort``: a total order, a stable ``torch.sort``.
"""

from __future__ import annotations

import torch

from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops.radix import LANES


def radix_cluster(keys, lo: int, hi: int, bits: int, chunk_rows: int = 1024,
                  device="cuda"):
    """MSB radix-cluster keys into 2^bits buckets of [lo, hi].

    keys: numpy array or tensor of int32 keys; device: where the pass runs,
    the card unless the caller asks for the CPU.  Returns (clustered
    (rows, 128) int32, starts (nchunks, cat_rows, 128)): within each chunk,
    bucket b's run is [starts[c, b], starts[c, b+1]) in flat order; keys
    outside [lo, hi] and the PAD fill sort to the chunk's tail.
    """
    span = hi - lo + 1
    range_bits = max((max(span - 1, 1)).bit_length(), bits)
    geom = radix_ops.RadixGeom(chunk_rows=chunk_rows, part_bits=bits, lo=lo,
                               hi=hi, shift=range_bits - bits)
    kin = radix_ops._chunk_pad(keys, chunk_rows * LANES, device)
    out, starts = radix_ops.partition_pass(kin, geom)
    nchunks = kin.numel() // (chunk_rows * LANES)
    return out, starts.view(nchunks, geom.cat_rows, LANES)


def radix_sort(keys: torch.Tensor, *payloads: torch.Tensor,
               descending: bool = False):
    """Sort rows by key, payload columns following; stable.

    Descending order sorts ~key ascending, as the JAX package does, so equal
    keys keep their input order either way.  Returns the sorted keys, or a
    tuple of the keys and each payload column.
    """
    order = torch.sort(~keys if descending else keys, stable=True).indices
    out = (keys[order], *(p[order] for p in payloads))
    return out if payloads else out[0]
