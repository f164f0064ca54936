"""PyTorch port: hash-mode partition and two-pass partitioning, exactly.

The plain twins against the JAX package's Pallas kernels in interpret mode
(chunk_rows 8 or 32): the hash-mode pass 1 bit for bit, pass 2 under its
contract (starts2 whole; the first starts2[b][F2] keys of each region bit
for bit, PAD after them, where the JAX kernel leaves other buckets' window
slack in hash mode), the two-pass planner's geometry and its None cases,
and run_join with RadixConfig(passes=2).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.config import BloomArgs as JBloomArgs
from hwbloomradixjoin_tpu.config import BloomVariant as JBloomVariant
from hwbloomradixjoin_tpu.config import EngineConfig as JEngineConfig
from hwbloomradixjoin_tpu.config import RadixConfig as JRadixConfig
from hwbloomradixjoin_tpu.models import run_join as jax_run_join
from hwbloomradixjoin_tpu.ops import bitmap_join as jbitmap_join
from hwbloomradixjoin_tpu.ops import bloom_pallas as jbloom_pallas
from hwbloomradixjoin_tpu.ops import multipass as jmultipass
from hwbloomradixjoin_tpu.ops import radix as jradix
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                               EngineConfig, RadixConfig)
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.models import registry, run_join
from hwbloomradixjoin_tpu_torch.ops import multipass, radix
from hwbloomradixjoin_tpu_torch.types import PAD_KEY, KeyStats, Relation
from port_cpu import lean_cpu  # noqa: F401  (autouse)


def _keys(rng, n, pad_frac=0.05):
    k = rng.integers(-2**31 + 1, 2**31, n, dtype=np.int64)
    k[rng.random(n) < pad_frac] = PAD_KEY
    return k.astype(np.int32)


@pytest.mark.parametrize("part_bits,hash_bits,nchunks", [(0, 7, 2), (4, 9, 3),
                                                         (10, 21, 2)])
def test_hash_partition_matches_jax(part_bits, hash_bits, nchunks):
    """Hash-mode pass 1 (the flagship's is 10 of 21 bits): keys and starts
    of partition_pass_plain equal the JAX kernel's, bit for bit."""
    rng = np.random.default_rng(part_bits)
    keys = _keys(rng, nchunks * 8 * 128)
    kw = dict(chunk_rows=8, part_bits=part_bits, hash_seed=42,
              hash_bits=hash_bits)
    got_k, got_s = radix.partition_pass(torch.from_numpy(keys),
                                        radix.RadixGeom(**kw))
    want_k, want_s = jradix.partition_pass(jnp.asarray(keys), interpret=True,
                                           geom=jradix.RadixGeom(**kw))
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    with pytest.raises(ValueError):
        radix.RadixGeom(part_bits=5, hash_seed=1, hash_bits=4)


def _pass1(keys, b1, chunk_rows, **kw):
    geom = dict(chunk_rows=chunk_rows, part_bits=b1, **kw)
    s1, st1 = radix.partition_pass(torch.from_numpy(keys),
                                   radix.RadixGeom(**geom))
    js1, jst1 = jradix.partition_pass(jnp.asarray(keys), interpret=True,
                                      geom=jradix.RadixGeom(**geom))
    assert np.array_equal(s1.numpy(), np.asarray(js1))
    return s1, st1, js1, jst1


@pytest.mark.parametrize("mode", ["range", "hash"])
def test_pass2_partition_matches_jax(mode):
    """pass2_partition_plain against the JAX kernel: starts2 equal in full,
    each region's first starts2[b][F2] keys equal, PAD after them.  The
    range stream holds keys below lo, above hi (inside and past the last
    buckets' power-of-two span) and PAD, so the window slack masks apply."""
    rng = np.random.default_rng(7)
    chunk_rows, nchunks, b1, b2 = 32, 4, 3, 2
    n = nchunks * chunk_rows * 128
    if mode == "hash":
        keys = _keys(rng, n)
        kw, p2kw = dict(hash_seed=42, hash_bits=9), dict(hash_seed=42,
                                                         hash_bits=9)
    else:
        lo, hi, shift = 1, 3000, 12 - b1 - b2
        k = rng.integers(lo, hi + 1, n)
        u = rng.random(n)
        k[u < 0.2] = rng.integers(hi + 1, 4200, int((u < 0.2).sum()))
        k[u < 0.05] = rng.integers(-2**31 + 1, lo, int((u < 0.05).sum()))
        k[u > 0.97] = PAD_KEY
        keys = k.astype(np.int32)
        kw = dict(lo=lo, hi=hi, shift=shift + b2)
        p2kw = dict(lo=lo, hi=hi, shift1=shift + b2, shift2=shift)
    s1, st1, js1, jst1 = _pass1(keys, b1, chunk_rows, **kw)
    geom = multipass.plan_pass2(s1, st1, b1, b2, chunk_rows, 512, **p2kw)
    assert geom.c1_rows < chunk_rows          # real windows, not whole chunks
    jgeom = jmultipass.Pass2Geom(**{f: getattr(geom, f)
                                    for f in geom.__dataclass_fields__})
    out, starts2 = multipass.pass2_partition(s1, st1, geom)
    jout, jstarts2 = jmultipass.pass2_partition(
        js1, jmultipass._descs1(jst1, jgeom), jgeom, interpret=True)
    assert np.array_equal(starts2.numpy(), np.asarray(jstarts2))
    F1, F2 = 1 << b1, 1 << b2
    live = starts2.numpy().reshape(F1, -1)[:, F2]
    out = out.numpy().reshape(F1, -1)
    jout = np.asarray(jout).reshape(F1, -1)
    for b in range(F1):
        assert np.array_equal(out[b, :live[b]], jout[b, :live[b]])
        assert (out[b, live[b]:] == PAD_KEY).all()
    in_range = (keys != PAD_KEY) if mode == "hash" \
        else (keys >= 1) & (keys <= 3000)
    assert live.sum() >= in_range.sum() > 0
    if mode == "hash":                # every non-PAD key has one bucket
        assert live.sum() == in_range.sum()


def test_plan_2pass_declines_like_jax():
    """None on the same inputs: under 2 partition bits, and a pass-1 run
    filling a chunk (every S key in one bucket)."""
    sk = np.full(8 * 128 * 3, 5, np.int32)
    for hi in (3000, 1 << 20):             # 0 bits; 6 bits, one full bucket
        rk = np.array([1, hi], np.int32)
        got = multipass.plan_radix_join_2pass(rk, sk, 1, hi, device="cpu",
                                              chunk_rows=8, num_radix_bits=6)
        want = jmultipass.plan_radix_join_2pass(
            jnp.asarray(rk), jnp.asarray(sk), 1, hi, interpret=True,
            chunk_rows=8, num_radix_bits=6)
        assert got is None and want is None


HI = 1 << 20          # 20 range bits: up to 8 partition bits


@pytest.fixture(scope="module")
def two_pass_workload():
    rng = np.random.default_rng(23)
    rk = np.concatenate([[1, HI], rng.choice(np.arange(2, HI), 30000,
                                             replace=False)]).astype(np.int32)
    rp = np.arange(len(rk), dtype=np.int32)
    sk = rng.integers(1, HI + HI // 4, 200_000).astype(np.int32)
    sp = np.arange(len(sk), dtype=np.int32)
    return rk, rp, sk, sp


def test_plan_radix_join_2pass_counts_exactly(two_pass_workload):
    """The two-pass plan's geometry is the JAX planner's rule (high half
    first, c1_rows from the largest run) and its count is ref_join's."""
    rk, rp, sk, sp = two_pass_workload
    plan = multipass.plan_radix_join_2pass(rk, sk, 1, HI, device="cpu",
                                           chunk_rows=64, num_radix_bits=6)
    assert isinstance(plan, multipass.TwoPassPlan)
    g = plan.pass2
    assert (g.b1, g.b2, g.shift1, g.shift2) == (3, 3, 17, 14)
    assert g.nchunks == -(-len(sk) // (64 * 128))
    assert plan.full_count() == native.ref_join(rk, rp, sk, sp)[0]
    assert list(plan.phase_fns()) == ["r_partition", "build", "s_partition",
                                      "s_pass2", "probe"]


@pytest.mark.parametrize("filtered", [False, True])
def test_run_join_two_passes_matches_jax(monkeypatch, two_pass_workload,
                                         filtered):
    """run_join("PRO", passes=2), without and behind a blocked filter: the
    two-pass plan, the JAX package's count and S-tuples after filter; a
    fan-out the two-pass planner declines falls back to one pass.  The JAX
    planners run at 64-row chunks (interpret mode caps their default at
    1,024 rows: one chunk here), the same plans over 4 chunks, and their
    phase timings, which no assertion reads, compile nothing."""
    for mod, name in ((jmultipass, "plan_radix_join_2pass"),
                      (jbitmap_join, "plan_radix_join"),
                      (jbloom_pallas, "plan_bloom_prune")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         chunk_rows=64))
    for cls in (jmultipass.TwoPassPlan, jbitmap_join.RadixJoinPlan):
        monkeypatch.setattr(cls, "_time", lambda self, fn: 0.0)
    rk, rp, sk, sp = two_pass_workload
    sk, sp = sk[:25_000], sp[:25_000]
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 22, k=2, B=512) \
        if filtered else None
    jargs = JBloomArgs(variant=JBloomVariant.BLOCKED, m=1 << 22, k=2,
                       B=512) if filtered else None
    cfg = RadixConfig(passes=2, num_radix_bits=6)
    jres, jst, _ = jax_run_join(
        "PRO", JRelation.from_numpy(rk, rp,
                                    stats=JKeyStats(1, HI, is_unique=True)),
        JRelation.from_numpy(sk, sp), JEngineConfig(
            interpret=True, radix=JRadixConfig(passes=2, num_radix_bits=6)),
        jargs)
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, HI, is_unique=True))
    S = Relation.from_numpy(sk, sp, device="cpu")
    res, st, sums = run_join("PRO", R, S, EngineConfig(radix=cfg), args)
    assert st.tier == "cuda_radix" and jst.tier == "pallas_radix"
    assert res.count() == jres.count() == native.ref_join(rk, rp, sk, sp)[0]
    assert res.s_after_filter == jres.s_after_filter
    assert "s_pass2" in st.phases and sums == (0, 0)
    # added left to right, as the registry adds them (Python's sum() of
    # floats compensates, so it may differ in the last bit)
    ph = st.phases
    assert st.part_usec == (ph.get("bloom_partition", 0.0)
                            + ph.get("bloom_probe", 0.0) + ph["s_partition"]
                            + ph["s_pass2"])
    plan = registry.plan_kernel_join("cuda_radix", R, S, EngineConfig(
        radix=cfg), *registry.key_ranges(R), bloom_args=args)
    assert isinstance(getattr(plan, "join", plan), multipass.TwoPassPlan)
    if filtered:
        want = native.ref_bloom("blocked", args.m, args.k, args.B, args.seed,
                                rk, sk).sum()
        assert res.s_after_filter == want
        return
    res1, st1, _ = run_join("PRO", R, S, EngineConfig(
        radix=RadixConfig(passes=2, num_radix_bits=1)))
    assert res1.count() == res.count() and "s_pass2" not in st1.phases


def test_split_bits_matches_jax():
    for bits in range(0, 21):
        assert RadixConfig().split_bits(bits) == \
            JRadixConfig().split_bits(bits)
