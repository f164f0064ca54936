"""PyTorch port: KEY_8B (16-byte tuples) against the JAX package.

The wide sort-scan functions against the JAX package's XLA functions on the
same (hi, lo) columns, exactly; run_join's KEY_8B tiers (the CPU twins of
``cuda_key8b``, the plain ``key8b`` and ``materialize8b``) against the JAX
package's run_join on the CPU (its XLA wide tier, no interpret mode) and
``native.ref_join``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hwbloomradixjoin_tpu.config import BloomArgs as JBloomArgs
from hwbloomradixjoin_tpu.config import BloomVariant as JBloomVariant
from hwbloomradixjoin_tpu.config import EngineConfig as JEngineConfig
from hwbloomradixjoin_tpu.data import native
from hwbloomradixjoin_tpu.models import run_join as jax_run_join
from hwbloomradixjoin_tpu.ops import xla_join as JX
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                               EngineConfig)
from hwbloomradixjoin_tpu_torch.models import run_join
from hwbloomradixjoin_tpu_torch.ops import xla_join as X
from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
from port_cpu import lean_cpu  # noqa: F401  (autouse)

PAD = -2**31
M64 = (1 << 64) - 1


def _fold(pair) -> int:
    """A JAX (hi, lo) uint32 pair -> the unsigned 64-bit value."""
    return ((int(pair[0]) & 0xFFFFFFFF) << 32) | (int(pair[1]) & 0xFFFFFFFF)


def _fold_cols(hi, lo) -> np.ndarray:
    return (np.asarray(hi).astype(np.int64) << 32) \
        | np.asarray(lo).astype(np.uint32).astype(np.int64)


def _wide_columns(seed=3, n_r=400, n_s=3000):
    """(hi, lo) key and payload columns of R and S: high words non-zero and
    negative, low words either side of the sign bit, R keys that repeat
    (twice and three times), S rows that are the (PAD, PAD) pair, misses,
    and payload high words large enough that the sums wrap mod 2^64."""
    rng = np.random.default_rng(seed)

    def i32(lo, hi, n):
        return rng.integers(lo, hi, n).astype(np.int32)

    r_hi, r_lo = i32(-3, 4, n_r), i32(-2**31 + 1, 2**31, n_r)
    r_hi[:20], r_lo[:20] = r_hi[20:40], r_lo[20:40]       # twice
    r_hi[40:50], r_lo[40:50] = r_hi[20:30], r_lo[20:30]   # three times
    pick = rng.integers(0, n_r, n_s)
    s_hi, s_lo = r_hi[pick].copy(), r_lo[pick].copy()
    miss = rng.random(n_s) < 0.3
    s_lo[miss] = i32(-2**31 + 1, 2**31, int(miss.sum()))
    s_hi[::97], s_lo[::97] = PAD, PAD
    pays = [i32(-2**31, 2**31, n) for n in (n_r, n_r, n_s, n_s)]
    return r_hi, r_lo, s_hi, s_lo, *pays


@pytest.mark.parametrize("fn", ["count", "count64", "materialize"])
def test_wide_functions_match_jax(fn):
    """count (sums mod 2^32), count64 (sums mod 2^64) and the materialized
    rows equal the JAX functions' on the same columns."""
    r_hi, r_lo, s_hi, s_lo, r_phi, r_plo, s_phi, s_plo = _wide_columns()
    t = [torch.from_numpy(a) for a in (r_hi, r_lo, s_hi, s_lo, r_phi,
                                       r_plo, s_phi, s_plo)]
    j = [jnp.asarray(a) for a in (r_hi, r_lo, s_hi, s_lo, r_phi, r_plo,
                                  s_phi, s_plo)]
    if fn == "count":
        got = X.sort_scan_count_wide(t[0], t[1], t[5], t[2], t[3], t[7])
        want = jax.jit(JX.sort_scan_count_wide)(j[0], j[1], j[5], j[2],
                                                j[3], j[7])
        assert [int(v) for v in got] == [int(want[0]), int(want[1]) &
                                         0xFFFFFFFF, int(want[2]) &
                                         0xFFFFFFFF]
        return
    if fn == "count64":
        cnt, sr, ss = X.sort_scan_count_wide64(*t[:2], t[4], t[5], *t[2:4],
                                               t[6], t[7])
        want = jax.jit(JX.sort_scan_count_wide64)(*j[:2], j[4], j[5],
                                                  *j[2:4], j[6], j[7])
        assert int(cnt) == int(want[0]) > 0
        assert (int(sr) & M64, int(ss) & M64) == (_fold(want[1]),
                                                  _fold(want[2]))
        # exact sums in Python integers: they leave [0, 2^64), so they wrap
        r_pay = {}
        for k, p in zip(_fold_cols(r_hi, r_lo).tolist(),
                        _fold_cols(r_phi, r_plo).tolist()):
            r_pay.setdefault(k, []).append(p)
        exact_r = exact_s = 0
        for k, p in zip(_fold_cols(s_hi, s_lo).tolist(),
                        _fold_cols(s_phi, s_plo).tolist()):
            exact_r += sum(r_pay.get(k, []))
            exact_s += p * len(r_pay.get(k, []))
        assert not 0 <= exact_r < 2**64 and not 0 <= exact_s < 2**64
        assert (int(sr) & M64, int(ss) & M64) == (exact_r & M64,
                                                  exact_s & M64)
        return
    cnt, out_r, out_s, out_k = X.sort_scan_materialize_wide(
        *t[:2], t[4], t[5], *t[2:4], t[6], t[7])
    jc, (orh, orl), (osh, osl), (okh, okl) = jax.jit(
        JX.sort_scan_materialize_wide)(
        *j[:2], j[4], j[5], *j[2:4], j[6], j[7])
    n = int(cnt)
    assert n == int(jc) > 0
    want = np.stack([_fold_cols(okh, okl), _fold_cols(orh, orl),
                     _fold_cols(osh, osl)], 1)
    got = torch.stack([out_k, out_r, out_s], 1).numpy()
    # matched rows: the same multiset (the order within a key is the sort's)
    assert sorted(map(tuple, got[:n].tolist())) == \
        sorted(map(tuple, want[:n].tolist()))
    # the rest: 0, 0 and the (PAD, PAD) pair, as in JAX
    np.testing.assert_array_equal(got[n:], want[n:])
    assert (got[n:, 0] == X.PAD_PAIR).all()


def _key8b_workload(case, seed=11, n_r=2000, n_s=9000):
    """int64 (keys, payloads) of R and S.  R's keys are 1..n_r shuffled,
    S's drawn over twice R's range; "hi" puts keys 2^32 + k in both (high
    words non-zero), "trunc" adds S keys 2^32 + k whose low word is an R
    key (the filter, on low words, lets them through; the join does not
    match them); payloads reach 2^40 so 64-bit sums wrap."""
    rng = np.random.default_rng(seed)
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int64)
    sk = rng.integers(1, 2 * n_r, n_s).astype(np.int64)
    if case == "hi":
        rk[::3] += 2**32
        sk[::5] += 2**32
    if case == "trunc":
        sk[::4] += 2**32
    rp = rng.integers(2**31, 2**40, n_r).astype(np.int64)
    sp = rng.integers(-2**40, 2**40, n_s).astype(np.int64)
    return rk, rp, sk, sp


def _pairs_on_host(rk, rp, sk, sp):
    pay = dict(zip(rk.tolist(), rp.tolist()))
    return sorted((pay[k], p) for k, p in zip(sk.tolist(), sp.tolist())
                  if k in pay)


@pytest.mark.parametrize("case,stats,bloom,tier", [
    ("zero_hi", True, False, "cuda_key8b"),
    ("zero_hi", True, True, "cuda_key8b"),
    ("trunc", True, True, "key8b"),
    ("trunc", False, True, "key8b"),
    ("hi", True, False, "key8b"),
    ("hi", False, True, "key8b"),
])
def test_key8b_joins_match_jax(case, stats, bloom, tier):
    """run_join over 16-byte tuples: cuda_key8b (its CPU twins) where R is
    declared unique and every high word is zero, else the plain key8b tier;
    the count, s_after_filter (the filter on low words, so truncation lets
    the high-word keys of "trunc" through, as tests/test_bitmap_join.py:182
    pins for the JAX package) and the 64-bit sums equal the JAX package's
    run_join on the CPU and the host's own join; a nonzero high word sends
    even a declared-unique R to the plain tier."""
    rk, rp, sk, sp = _key8b_workload(case)
    top = int(rk.max())
    ks = KeyStats(1, top, is_unique=True) if stats else None
    jks = JKeyStats(1, top, is_unique=True) if stats else None
    R = Relation.from_numpy(rk, rp, device="cpu", stats=ks, key8b=True)
    S = Relation.from_numpy(sk, sp, device="cpu", key8b=True)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 16, k=2, B=512) \
        if bloom else None
    jargs = JBloomArgs(variant=JBloomVariant.BLOCKED, m=1 << 16, k=2,
                       B=512) if bloom else None
    res, st, sums = run_join("PRO", R, S, EngineConfig(), args)
    jres, jst, jsums = jax_run_join(
        "PRO", JRelation.from_numpy(rk, rp, stats=jks, key8b=True),
        JRelation.from_numpy(sk, sp, key8b=True), JEngineConfig(key8b=True),
        jargs)
    assert st.tier == tier and jst.tier == "key8b"
    want = _pairs_on_host(rk, rp, sk, sp)
    assert res.count() == jres.count() == len(want) > 0
    assert res.s_after_filter == jres.s_after_filter
    if case == "trunc":
        trunc = int(np.isin(sk & 0xFFFFFFFF, rk).sum())
        assert res.s_after_filter >= trunc > len(want)
    if tier == "cuda_key8b":
        assert sums == (0, 0)
        assert native.ref_join(rk.astype(np.int32), rp.astype(np.int32),
                               sk.astype(np.int32),
                               sp.astype(np.int32))[0] == res.count()
    else:
        assert sums == jsums
        assert sums == (sum(r for r, _ in want) & M64,
                        sum(s for _, s in want) & M64)


def test_key8b_payloads_of_32_bits_sum_mod_2_32():
    """A 16-byte-key relation without payload high words takes the 32-bit
    wide function: sums mod 2^32, as the JAX package's."""
    rk, rp, sk, sp = _key8b_workload("hi", n_r=500, n_s=3000)
    rp, sp = rp.astype(np.int32), sp.astype(np.int32)

    def rel(mod, k, p):
        full = mod.from_numpy(k, p, key8b=True, **(
            {"device": "cpu"} if mod is Relation else {}))
        return mod(key=full.key, payload=full.payload, key_hi=full.key_hi)

    res, st, sums = run_join("PRO", rel(Relation, rk, rp),
                             rel(Relation, sk, sp))
    jres, jst, jsums = jax_run_join("PRO", rel(JRelation, rk, rp),
                                    rel(JRelation, sk, sp))
    assert st.tier == jst.tier == "key8b"
    assert res.count() == jres.count() > 0
    assert sums == tuple(int(v) & 0xFFFFFFFF for v in jsums)


def test_materialize8b_pairs_match_jax():
    """materialize8b over a unique R: the int64 pairs, as a multiset, equal
    the JAX package's and the host's."""
    rk, rp, sk, sp = _key8b_workload("hi", n_r=800, n_s=3000)
    res, st, sums = run_join(
        "PRO", Relation.from_numpy(rk, rp, device="cpu", key8b=True,
                                   stats=KeyStats(1, 2**33, is_unique=True)),
        Relation.from_numpy(sk, sp, device="cpu", key8b=True),
        EngineConfig(materialize=True))
    jres, jst, _ = jax_run_join(
        "PRO", JRelation.from_numpy(rk, rp, key8b=True),
        JRelation.from_numpy(sk, sp, key8b=True),
        JEngineConfig(key8b=True, materialize=True))
    assert st.tier == jst.tier == "materialize8b" and sums == (0, 0)
    n = res.count()
    assert res.r_payload.dtype == torch.int64 and len(res.r_payload) == n
    got = sorted(zip(res.r_payload.tolist(), res.s_payload.tolist()))
    jgot = sorted(zip(np.asarray(jres.r_payload)[:n].tolist(),
                      np.asarray(jres.s_payload)[:n].tolist()))
    assert n == jres.count() and got == jgot == _pairs_on_host(rk, rp, sk,
                                                               sp)


def test_materialize8b_repeated_r_key_gives_every_pair():
    """The JAX package's materialize8b emits no pair for an S row whose key
    repeats in R (its sort_scan_materialize_wide keeps segments with one R
    row), where the reference emits one pair a copy: pinned here on a key
    that R holds three times, 3 pairs of the reference's 9.  The port's
    materialize8b, over an R not declared unique, emits all 9; over
    random 16-byte columns with keys twice and three times in R, its pairs
    equal the host's all-pairs join."""
    rk = np.array([5, 7, 7, 7, 9], np.int64)
    rp = np.array([50, 70, 71, 72, 90], np.int64)
    sk = np.array([7, 5, 7, 9, 11, 9], np.int64)
    sp = np.array([1, 2, 3, 4, 5, 6], np.int64)
    jres, jst, _ = jax_run_join(
        "PRO", JRelation.from_numpy(rk, rp, key8b=True),
        JRelation.from_numpy(sk, sp, key8b=True),
        JEngineConfig(key8b=True, materialize=True))
    n = jres.count()
    assert jst.tier == "materialize8b" and n == 3
    assert sorted(zip(np.asarray(jres.r_payload)[:n].tolist(),
                      np.asarray(jres.s_payload)[:n].tolist())) == \
        [(50, 2), (90, 4), (90, 6)]
    # the reference's all-pairs join: one pair a copy of each R key
    want = [(50, 2), (70, 1), (70, 3), (71, 1), (71, 3), (72, 1), (72, 3),
            (90, 4), (90, 6)]
    assert sum(int((rk == k).sum()) for k in sk) == len(want)
    res, st, sums = run_join(
        "PRO", Relation.from_numpy(rk, rp, device="cpu", key8b=True),
        Relation.from_numpy(sk, sp, device="cpu", key8b=True),
        EngineConfig(materialize=True))
    assert st.tier == "materialize8b" and sums == (0, 0)
    assert res.count() == 9 and res.r_payload.dtype == torch.int64
    assert sorted(zip(res.r_payload.tolist(), res.s_payload.tolist())) == want
    # the keys and payloads fit 32 bits: ref_join's count and sums agree
    assert native.ref_join(rk, rp, sk, sp) == (
        9, sum(r for r, _ in want), sum(s for _, s in want))

    r_hi, r_lo, s_hi, s_lo, r_phi, r_plo, s_phi, s_plo = _wide_columns()
    rk, sk = _fold_cols(r_hi, r_lo), _fold_cols(s_hi, s_lo)
    rp, sp = _fold_cols(r_phi, r_plo), _fold_cols(s_phi, s_plo)
    res, st, _ = run_join(
        "PRO", Relation.from_numpy(rk, rp, device="cpu", key8b=True),
        Relation.from_numpy(sk, sp, device="cpu", key8b=True),
        EngineConfig(materialize=True))
    pays = {}
    for k, p in zip(rk.tolist(), rp.tolist()):
        pays.setdefault(k, []).append(p)
    want = sorted((r, p) for k, p in zip(sk.tolist(), sp.tolist())
                  if k != X.PAD_PAIR for r in pays.get(k, []))
    assert max(len(v) for v in pays.values()) == 3
    assert res.count() == len(want) > 0
    assert sorted(zip(res.r_payload.tolist(), res.s_payload.tolist())) == want
