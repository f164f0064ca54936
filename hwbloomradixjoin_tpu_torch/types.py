"""Core table types on torch tensors: columnar relations and join results.

Counterpart of ``hwbloomradixjoin_tpu/types.py``.  A relation is a pair of
dense columns (``key[n]``, ``payload[n]``), int32 by default; with ``key8b``
64-bit keys and payloads ride as (hi, lo) int32 column pairs, as in the JAX
package, so arrays cross between the two with
``torch.from_numpy(np.asarray(x))``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

PAD_KEY = -2**31


def key_dtype(key8b: bool = False) -> torch.dtype:
    """Key and payload dtype: int32 (8-byte tuples) or int64 (16-byte
    tuples, KEY_8B), as the JAX package's key_dtype."""
    return torch.int64 if key8b else torch.int32


@dataclasses.dataclass(frozen=True)
class KeyStats:
    """Declared key metadata (constraint-grade, set by construction).

    is_dense_pk=True asserts keys are exactly a permutation of
    [min_key, max_key]; is_unique asserts a primary key.  The bitmap radix
    engine requires uniqueness only.
    """

    min_key: int
    max_key: int
    is_dense_pk: bool = False
    is_unique: bool = False


def _int32_column(x: np.ndarray) -> torch.Tensor:
    """int32 column sharing x's memory where it can (read-only arrays, such
    as views of JAX arrays, are copied: torch tensors are writable)."""
    x = np.ascontiguousarray(x, dtype=np.int32)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def _int32_columns(x: np.ndarray):
    """int64 values -> (hi, lo) int32 columns (lo keeps the low 32 bits)."""
    x64 = np.asarray(x, dtype=np.int64)
    lo = torch.from_numpy((x64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    hi = torch.from_numpy((x64 >> 32).astype(np.int32))
    return hi, lo


@dataclasses.dataclass(frozen=True)
class Relation:
    """A columnar relation: parallel key/payload tensors on one device.

    ``num_valid`` marks capacity-padded relations (padding slots hold
    PAD_KEY); ``key_hi``/``payload_hi`` carry the high words of 16-byte
    tuples (KEY_8B), None for 8-byte tuples.
    """

    key: torch.Tensor
    payload: torch.Tensor
    key_hi: Optional[torch.Tensor] = None
    payload_hi: Optional[torch.Tensor] = None
    num_valid: Optional[int] = None
    stats: Optional[KeyStats] = None

    PAD_KEY = np.int32(PAD_KEY)

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def num_tuples(self) -> int:
        return self.capacity if self.num_valid is None else self.num_valid

    @property
    def device(self) -> torch.device:
        return self.key.device

    @staticmethod
    def from_numpy(key: np.ndarray, payload: Optional[np.ndarray] = None,
                   device="cuda", stats: Optional[KeyStats] = None,
                   key8b: bool = False) -> "Relation":
        """Build a relation on `device` (the card unless the caller asks for
        the CPU) from numpy columns."""
        if payload is None:
            payload = np.arange(key.shape[0], dtype=np.int32)
        khi = phi = None
        if key8b:
            khi, k = _int32_columns(key)
            phi, p = _int32_columns(payload)
        else:
            k, p = _int32_column(key), _int32_column(payload)

        def put(t):
            return None if t is None else t.to(device)
        return Relation(key=put(k), payload=put(p), key_hi=put(khi),
                        payload_hi=put(phi), stats=stats)

    def to_numpy(self):
        n = self.num_tuples
        return (self.key[:n].cpu().numpy(), self.payload[:n].cpu().numpy())


@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Result of a join: match count, and optionally materialized rid pairs."""

    total_results: int
    s_after_filter: Optional[int] = None
    r_payload: Optional[torch.Tensor] = None
    s_payload: Optional[torch.Tensor] = None

    def count(self) -> int:
        return int(self.total_results)
