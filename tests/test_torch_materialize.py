"""PyTorch port: materialization vs the JAX package.

On the CPU the kernel wrapper runs its plain twin.  One JAX run_join on the
pallas_materialize tier (interpret mode) is the reference of the kernel
tier; the portable tier's sort-based twins are held to the JAX XLA versions
array for array; every join is also held to ref_join's count and a numpy
pair multiset.  Integer results, so the tolerance is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.config import EngineConfig as JEngineConfig
from hwbloomradixjoin_tpu.models import run_join as jax_run_join
from hwbloomradixjoin_tpu.ops import xla_join as JX
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                               EngineConfig, RadixConfig)
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.models import bloom_join, run_join
from hwbloomradixjoin_tpu_torch.ops import prho_join as TP
from hwbloomradixjoin_tpu_torch.ops import radix as TR
from hwbloomradixjoin_tpu_torch.ops import xla_join as TX
from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
from port_cpu import lean_cpu  # noqa: F401  (autouse)

PAD = -2**31


def _workload(seed=13, n_r=3000, n_s=20000, unique=True):
    """R keys in [1, n_r] (a permutation, or drawn with repeats), S keys in
    [1, 3 n_r) plus PAD and negative keys; payloads over all of int32,
    -2^31 included."""
    rng = np.random.default_rng(seed)
    rk = rng.permutation(np.arange(1, n_r + 1)) if unique \
        else rng.integers(1, n_r // 2, n_r)
    sk = rng.integers(1, 3 * n_r, n_s)
    sk[rng.random(n_s) < 0.05] = PAD
    sk[rng.random(n_s) < 0.05] = -7
    rp = rng.integers(-2**31, 2**31, n_r, dtype=np.int64)
    sp = rng.integers(-2**31, 2**31, n_s, dtype=np.int64)
    rp[::97], sp[::89] = -2**31, -2**31
    return tuple(a.astype(np.int32) for a in (rk, rp, sk, sp))


def _pairs(rk, rp, sk, sp):
    """The join's (r_pay, s_pay) pairs, sorted, in numpy."""
    order = np.argsort(rk, kind="stable")
    lo = np.searchsorted(rk[order], sk, side="left")
    hi = np.searchsorted(rk[order], sk, side="right")
    s_idx = np.repeat(np.arange(len(sk)), hi - lo)
    r_idx = order[np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)]
                                 or [np.zeros(0, np.int64)]).astype(np.int64)]
    return sorted(zip(rp[r_idx].tolist(), sp[s_idx].tolist()))


def _got(res):
    return sorted(zip(res.r_payload.tolist(), res.s_payload.tolist()))


@functools.lru_cache(maxsize=None)
def _jax_pallas_materialize():
    """The JAX pallas_materialize tier's (tier, count, sorted pairs) over
    _workload(), computed once per worker."""
    rk, rp, sk, sp = _workload()
    res, st, _ = jax_run_join(
        "PRO", JRelation.from_numpy(rk, rp, stats=JKeyStats(
            1, len(rk), is_unique=True)), JRelation.from_numpy(sk, sp),
        JEngineConfig(interpret=True, materialize=True))
    return st.tier, res.count(), sorted(zip(
        np.asarray(res.r_payload).tolist(), np.asarray(res.s_payload).tolist()))


def test_kernel_tier_matches_jax_pallas_materialize():
    """Unique R: the cuda_materialize tier (its twins here) emits the JAX
    Pallas tier's pairs and count, and ref_join's count."""
    rk, rp, sk, sp = _workload()
    jtier, jcount, jpairs = _jax_pallas_materialize()
    assert jtier == "pallas_materialize"
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, len(rk), is_unique=True))
    res, st, sums = run_join("PRO", R, Relation.from_numpy(sk, sp,
                                                           device="cpu"),
                             EngineConfig(materialize=True), inner_repeats=2)
    assert st.tier == "cuda_materialize" and sums == (0, 0)
    assert res.count() == st.result == jcount \
        == native.ref_join(rk, rp, sk, sp)[0] == len(res.r_payload)
    assert _got(res) == jpairs == _pairs(rk, rp, sk, sp)
    assert list(st.phases) == ["r_partition", "build", "s_partition",
                               "materialize"]
    assert st.probe_usec == st.phases["materialize"]
    assert st.build_usec == st.phases["r_partition"] + st.phases["build"]
    assert st.part_usec == st.phases["s_partition"]


def test_materialize_pairs_images():
    """Slot for slot: (r_pay, s_pay, key) where S key i has its count slot
    set, PAD elsewhere (keys below lo, above hi, PAD), and the count."""
    rk, rp, sk, sp = _workload(seed=3, n_r=5000, n_s=3 * 1024)
    lo, hi = 1, 5000
    pb, shift, slr = TP.plan_geometry_counts(lo, hi, 3)
    geom = TR.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift)
    r_part = TR.partition_pass_kv(TR._chunk_pad(rk, 1024, "cpu"),
                                  TR._chunk_pad(rp, 1024, "cpu"), geom)
    tables = TP.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                            r_part[2])
    s_part = TR.partition_pass_kv(torch.from_numpy(sk), torch.from_numpy(sp),
                                  geom)
    out_r, out_s, out_k, n = TP.materialize_pairs(
        *tables, s_part[0], s_part[1], lo, shift, pb, slr, s_part[2])
    keys, pays = s_part[0].numpy().ravel(), s_part[1].numpy().ravel()
    rmap = dict(zip(rk.tolist(), rp.tolist()))
    hit = np.array([k in rmap for k in keys.tolist()])
    assert out_k.shape == s_part[0].shape and int(n) == hit.sum()
    np.testing.assert_array_equal(out_k.numpy().ravel(),
                                  np.where(hit, keys, PAD))
    np.testing.assert_array_equal(out_s.numpy().ravel(),
                                  np.where(hit, pays, PAD))
    np.testing.assert_array_equal(
        out_r.numpy().ravel(),
        np.array([rmap.get(k, PAD) for k in keys.tolist()], np.int32))
    with pytest.raises(ValueError):
        TP.materialize_pairs(*tables, s_part[0], s_part[1][:-1], lo, shift,
                             pb, slr)


def test_plan_declines_a_repeated_build_key():
    rk, rp, sk, sp = _workload(seed=5, n_r=2000)
    rk[7] = rk[8]
    assert TP.plan_materialize_join(rk, rp, sk, sp, 1, 2000,
                                    device="cpu") is None
    assert TP.plan_materialize_join(np.delete(rk, 8), np.delete(rp, 8), sk,
                                    sp, 1, 2000, device="cpu",
                                    chunk_rows=8) is not None


@pytest.mark.parametrize("unique", [True, False])
def test_sort_scan_materialize_matches_jax_xla(unique):
    """The portable tier's twins equal the JAX XLA functions array for
    array: sort_scan_materialize (unique R) and sort_scan_materialize_multi
    (all pairs, capacity from a pre-count, PAD past the total)."""
    rk, rp, sk, sp = _workload(seed=21, n_r=1500, n_s=9000, unique=unique)
    args = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    if unique:
        want = jax.jit(JX.sort_scan_materialize)(*map(jnp.asarray,
                                                     (rk, rp, sk, sp)))
        got = TX.sort_scan_materialize(*args)
    else:
        cap = native.ref_join(rk, rp, sk, sp)[0] + 37
        want = jax.jit(JX.sort_scan_materialize_multi, static_argnums=4)(
            *map(jnp.asarray, (rk, rp, sk, sp)), cap)
        got = TX.sort_scan_materialize_multi(*args, cap)
    assert int(got[0]) == int(want[0]) == native.ref_join(rk, rp, sk, sp)[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("unique,bloom", [(True, None), (True, "blocked"),
                                          (False, None), (False, "blocked"),
                                          (True, "basic")])
def test_run_join_materialize_matches_ref(unique, bloom):
    """run_join(materialize=True): unique R on cuda_materialize, any other
    R on the portable tier (all pairs), with and without a filter (which
    drops no match): ref_join's count and the numpy pair multiset; with a
    filter, S-tuples after filter are the plain prune's."""
    rk, rp, sk, sp = _workload(seed=8, unique=unique)
    stats = KeyStats(1, len(rk), is_unique=True) if unique else None
    R = Relation.from_numpy(rk, rp, device="cpu", stats=stats)
    S = Relation.from_numpy(sk, sp, device="cpu")
    args = None if bloom is None else BloomArgs(
        variant=BloomVariant(bloom), m=1 << 16, k=3, B=512)
    res, st, sums = run_join("PRO", R, S, EngineConfig(materialize=True),
                             args)
    assert st.tier == ("cuda_materialize" if unique else "materialize")
    want = _pairs(rk, rp, sk, sp)
    assert res.count() == len(want) == native.ref_join(rk, rp, sk, sp)[0]
    assert _got(res) == want and sums == (0, 0)
    if args is not None:
        assert res.s_after_filter == \
            int(bloom_join.bloom_prune(R.key, S.key, args)[1])


def test_materialize_without_kernels_takes_the_portable_tier():
    rk, rp, sk, sp = _workload(seed=9, n_r=1000, n_s=5000)
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, 1000, is_unique=True))
    res, st, _ = run_join("PRHO", R, Relation.from_numpy(sk, sp, device="cpu"),
                          EngineConfig(radix=RadixConfig(use_kernels=False),
                                       materialize=True))
    assert st.tier == "materialize"
    assert _got(res) == _pairs(rk, rp, sk, sp)
