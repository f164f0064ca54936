"""Deterministic relation generators: uniform, Zipf, non-unique and
full-range.

Counterpart of ``hwbloomradixjoin_tpu/data/generator.py`` (lines 43-218),
copied rather than imported because importing the JAX package
imports jax.  ``parallel_create_relation`` reproduces the reference's
threshold-selectivity generator multiset-exactly (generator.c:161-221,
304-415) in numpy; the key order is a seeded permutation (the reference's
shuffle is time-seeded).  The Zipf, non-unique and full-range generators
replay glibc rand() streams through the port's copy of the native binding
(``data/native.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from hwbloomradixjoin_tpu_torch.data import native

INT_MAX = 2147483647
PAGE_SIZE = 4096


def _cycle_keys_below(first: int, count: int, threshold: int) -> np.ndarray:
    """Key sequence starting at `first`, stepping +1, wrapping threshold -> 1.

    first may be 0 (when (offset+1) % threshold == 0), in which case 0 is
    emitted once and the cycle continues from 1 (generator.c:184-188).
    """
    if count <= 0:
        return np.empty(0, dtype=np.int64)
    idx = np.arange(count, dtype=np.int64)
    if first == 0:
        out = np.empty(count, dtype=np.int64)
        out[0] = 0
        out[1:] = (idx[: count - 1] % threshold) + 1
        return out
    return ((first - 1 + idx) % threshold) + 1


def _cycle_keys_above(first: int, count: int, threshold: int) -> np.ndarray:
    """Above-threshold keys: start at `first`, wrap INT_MAX -> threshold+1."""
    if count <= 0:
        return np.empty(0, dtype=np.int64)
    span = INT_MAX - threshold  # cycle [threshold+1, INT_MAX]
    idx = np.arange(count, dtype=np.int64)
    if first == threshold:  # (offset_above+1) % range == 0 edge
        out = np.empty(count, dtype=np.int64)
        out[0] = threshold
        out[1:] = threshold + ((idx[: count - 1]) % span) + 1
        return out
    return threshold + ((first - threshold - 1 + idx) % span) + 1


def parallel_create_relation(num_tuples: int, nthreads: int, maxid: int,
                             threshold: int, selectivity: float,
                             shuffle_seed: int | None = None,
                             tuple_bytes: int = 8):
    """Multiset-exact reproduction of the reference parallel PK generator.

    Returns (keys, payloads) as int32 arrays.  payload = original rid (the
    reference shuffles keys only, so payloads stay 0..n-1 in slot order).
    """
    n = int(num_tuples)
    npages = (n * tuple_bytes) // PAGE_SIZE + 1
    npages_perthr = npages // nthreads
    ntuples_perthr = npages_perthr * (PAGE_SIZE // tuple_bytes)
    ntuples_above = int(n * (1.0 - selectivity))
    if npages_perthr == 0:
        ntuples_perthr = n // nthreads
    ntuples_above_perthr = int(ntuples_perthr * (1.0 - selectivity))
    ntuples_lastthr = n - ntuples_perthr * (nthreads - 1)
    ntuples_above_lastthr = ntuples_above - (nthreads - 1) * ntuples_above_perthr

    keys = np.empty(n, dtype=np.int64)
    offset = 0
    offset_above = 0
    for t in range(nthreads):
        firstkey = (offset + 1) % threshold
        firstkey_above = threshold + (offset_above + 1) % max(1, maxid - threshold)
        nt = ntuples_lastthr if t == nthreads - 1 else ntuples_perthr
        na = ntuples_above_lastthr if t == nthreads - 1 else ntuples_above_perthr
        nb = nt - na
        start = offset + offset_above
        keys[start:start + nb] = _cycle_keys_below(firstkey, nb, threshold)
        keys[start + nb:start + nt] = _cycle_keys_above(firstkey_above, na,
                                                        threshold)
        offset += ntuples_perthr - ntuples_above_perthr
        offset_above += ntuples_above_perthr

    keys = keys.astype(np.int32)
    payloads = np.arange(n, dtype=np.int32)
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        keys = keys[rng.permutation(n)]
    return keys, payloads


def create_relation_zipf(seed: int, num_tuples: int, maxid: int,
                         zipf_param: float):
    """Zipf-distributed keys over a permuted alphabet 1..maxid (bit-exact
    with the reference's genzipf); payload = rid."""
    keys = native.gen_zipf(seed, num_tuples, maxid, zipf_param)
    return keys, np.arange(num_tuples, dtype=np.int32)


def create_relation_nonunique(seed: int, num_tuples: int, maxid: int):
    """Keys uniform in [0, maxid) from rand() seeded `seed`; payload = rid."""
    keys = native.random_gen(seed, num_tuples, 0, maxid)
    return keys, np.arange(num_tuples, dtype=np.int32)


def create_relation_nonunique_from_pk(seed: int, pk_keys: np.ndarray,
                                      num_tuples: int, threshold: int,
                                      selectivity: float):
    keys = native.nonunique_from_pk(seed, pk_keys, num_tuples, threshold,
                                    selectivity)
    return keys, np.arange(num_tuples, dtype=np.int32)


def create_relation_fk_from_pk(seed: int, pk_keys: np.ndarray,
                               pk_pays: np.ndarray, num_tuples: int,
                               threshold: int, selectivity: float):
    return native.fk_from_pk(seed, pk_keys, pk_pays, num_tuples, threshold,
                             selectivity)


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    """Relation-construction parameters, mirroring param_t (src/main.c)."""

    r_size: int = 128_000_000
    s_size: int = 128_000_000
    r_seed: int = 12345
    s_seed: int = 54321
    nthreads: int = 2
    skew: float = 0.0
    selectivity: float = 1.0
    nonunique_keys: bool = False
    fullrange_keys: bool = False
    key8b: bool = False


def build_workload(p: WorkloadParams):
    """Build (R_keys, R_pays, S_keys, S_pays) as main.c:416-467 does.

    - default: R = parallel PK over [1, r_size]; S = parallel FK with
      selectivity threshold r_size, or Zipf over [1, r_size] (skew > 0);
    - full-range: R non-unique over [0, ceil(INT_MAX*sel)), S = fk_from_pk;
    - non-unique: R non-unique over [0, min(r_size, ceil(INT_MAX*sel))),
      S = nonunique_from_pk.
    """
    if p.fullrange_keys:
        threshold = math.ceil(INT_MAX * p.selectivity)
        rk, rp = create_relation_nonunique(p.r_seed, p.r_size, threshold)
        sk, sp = create_relation_fk_from_pk(p.s_seed, rk, rp, p.s_size,
                                            threshold, p.selectivity)
        return rk, rp, sk, sp
    if p.nonunique_keys:
        threshold = min(p.r_size, math.ceil(INT_MAX * p.selectivity))
        rk, rp = create_relation_nonunique(p.r_seed, p.r_size, threshold)
        sk, sp = create_relation_nonunique_from_pk(p.s_seed, rk, p.s_size,
                                                   threshold, p.selectivity)
        return rk, rp, sk, sp
    tb = 16 if p.key8b else 8
    rk, rp = parallel_create_relation(p.r_size, p.nthreads, p.r_size,
                                      p.r_size, 1.0, shuffle_seed=p.r_seed,
                                      tuple_bytes=tb)
    if p.skew > 0:
        sk, sp = create_relation_zipf(p.s_seed, p.s_size, p.r_size, p.skew)
    else:
        sk, sp = parallel_create_relation(p.s_size, p.nthreads, INT_MAX,
                                          p.r_size, p.selectivity,
                                          shuffle_seed=p.s_seed,
                                          tuple_bytes=tb)
    return rk, rp, sk, sp


def r_key_stats(p: WorkloadParams):
    """Declared build-side key constraints for a generated workload.

    The uniform PK generator emits each key in [1, r_size] exactly once, so R
    is a dense primary key by construction; other workloads get none.
    """
    from hwbloomradixjoin_tpu_torch.types import KeyStats

    if p.fullrange_keys or p.nonunique_keys:
        return None
    return KeyStats(min_key=1, max_key=p.r_size, is_dense_pk=True,
                    is_unique=True)


def expected_uniform_match_count(s_size: int, selectivity: float) -> int:
    """Exact match count for the uniform PK/FK workload: n - floor(n*(1-q))."""
    return s_size - int(s_size * (1.0 - selectivity))
