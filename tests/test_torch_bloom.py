"""PyTorch port: the bloom filter, the prune and filtered joins, exactly.

The port's filter against the JAX package's XLA filter and the reference's
scalar filter (``native.ref_bloom``), its false-positive rates against the
reference's goldens, its prune plans (one and two hash passes) against the
JAX package's Pallas prune in interpret mode (the same survivor multiset and
count), and ``run_join`` with a filter against the JAX package's
``run_join``: count, checksums and S-tuples after filter.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.config import BloomArgs as JBloomArgs
from hwbloomradixjoin_tpu.config import BloomVariant as JBloomVariant
from hwbloomradixjoin_tpu.config import EngineConfig as JEngineConfig
from hwbloomradixjoin_tpu.config import RadixConfig as JRadixConfig
from hwbloomradixjoin_tpu.models import bloom_join as jbloom_join
from hwbloomradixjoin_tpu.models import run_join as jax_run_join
from hwbloomradixjoin_tpu.ops import bitmap_join as jbitmap_join
from hwbloomradixjoin_tpu.ops import bloom as jbloom
from hwbloomradixjoin_tpu.ops import bloom_pallas as jbloom_pallas
from hwbloomradixjoin_tpu.ops import multipass as jmultipass
from hwbloomradixjoin_tpu.ops import prho_join as jprho_join
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                               EngineConfig, RadixConfig)
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.models import bloom_join, registry, run_join
from hwbloomradixjoin_tpu_torch.ops import bloom, bloom_pallas, hashes
from hwbloomradixjoin_tpu_torch.types import PAD_KEY, KeyStats, Relation

PAD = np.int32(PAD_KEY)


def _jargs(args: BloomArgs) -> JBloomArgs:
    """The JAX package's BloomArgs with the same fields."""
    return JBloomArgs(variant=JBloomVariant(args.variant.value), m=args.m,
                      k=args.k, B=args.B, seed=args.seed)


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31 + 1, 2**31, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("variant", ["basic", "blocked"])
def test_filter_matches_jax_and_reference(variant):
    """build_bitmap/probe_bitmap == JAX build_bitmap_xla/probe_bitmap_xla
    == the reference's scalar filter, bit for bit."""
    add = _keys(1, 20_000)
    query = np.concatenate([add[:5000], _keys(2, 20_000)])
    args = BloomArgs(variant=BloomVariant(variant), m=1 << 16, k=3, B=512)
    words = bloom.build_bitmap(torch.from_numpy(add), args)
    assert words.dtype == torch.int32 and words.shape == (args.m // 32,)
    jwords = np.asarray(jbloom.build_bitmap_xla(jnp.asarray(add),
                                                _jargs(args)))
    want_mask, want_bytes = native.ref_bloom(variant, args.m, args.k, args.B,
                                             args.seed, add, query,
                                             want_bitmap=True)
    assert np.array_equal(words.numpy().view(np.uint32), jwords)
    assert np.array_equal(words.numpy().view(np.uint8), want_bytes)
    mask = bloom.probe_bitmap(words, torch.from_numpy(query), args).numpy()
    jmask = np.asarray(jbloom.probe_bitmap_xla(jnp.asarray(jwords),
                                               jnp.asarray(query),
                                               _jargs(args)))
    assert np.array_equal(mask, jmask) and np.array_equal(mask, want_mask)
    assert mask[:5000].all()
    assert np.array_equal(bloom.build_bitmap_host(add, args), jwords)
    assert np.array_equal(bloom.probe_bitmap_host(jwords, query, args), mask)


# the reference's unittests run of tests/test_bloom.py (m = 2^20, 131072
# inserts, 10^6 probes over a disjoint key range), fpr_emp in percent
GOLDEN_FPR = {
    ("blocked", 1): 11.778, ("blocked", 2): 4.940, ("blocked", 3): 3.175,
    ("blocked", 4): 2.530, ("blocked", 5): 2.334, ("blocked", 6): 2.366,
    ("basic", 1): 11.721, ("basic", 2): 4.882, ("basic", 3): 3.046,
    ("basic", 4): 2.383, ("basic", 5): 2.184, ("basic", 6): 2.165,
}


@functools.lru_cache(maxsize=None)
def _fpr_keysets():
    seed, n_ins, n_samples = 817263, 131072, 1_000_000
    threshold = int(2147483647 * (n_ins / (n_ins + n_samples)))
    r, used = native.unique_gen_range(seed + 1, 0, n_ins, 0, threshold)
    s, _ = native.unique_gen_range(seed + 1, used, n_samples, threshold + 1,
                                   2147483647)
    return torch.from_numpy(r), torch.from_numpy(s), \
        int(native.rand_stream(seed, 1)[0])


@pytest.mark.parametrize("variant", ["blocked", "basic"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_fpr_matches_reference_goldens(variant, k):
    """The false-positive rate of the port's torch filter, built and probed
    in plain torch, equals the reference's to the printed digit."""
    r, s, fseed = _fpr_keysets()
    args = BloomArgs(variant=BloomVariant(variant), m=1 << 20, k=k, B=512,
                     seed=fseed)
    words = bloom.build_bitmap(r, args)
    fpr = int(bloom.probe_bitmap(words, s, args).sum()) / s.numel() * 100.0
    assert round(fpr, 3) == GOLDEN_FPR[(variant, k)]


def test_theoretical_fpr():
    assert round(bloom.theoretical_fpr(1 << 30, 1, 128_000_000) * 100,
                 3) == 11.238
    assert round(bloom.theoretical_fpr(1 << 30, 6, 128_000_000) * 100,
                 3) == 1.779


def test_bloom_args_carried_across():
    """The port's BloomArgs built from the JAX one's fields (and its checks)
    gives the filter words the JAX package builds from the same keys."""
    add = _keys(3, 5000)
    for jargs in (JBloomArgs(), JBloomArgs(variant=JBloomVariant.BLOCKED,
                                           m=1 << 18, k=4, B=256, seed=7)):
        args = BloomArgs(variant=BloomVariant(jargs.variant.value),
                         m=jargs.m, k=jargs.k, B=jargs.B, seed=jargs.seed)
        assert args.nblocks == jargs.nblocks
        jw = np.asarray(jbloom.build_bitmap_xla(jnp.asarray(add), jargs))
        assert np.array_equal(bloom.build_bitmap(torch.from_numpy(add),
                                                 args).numpy().view(np.uint32),
                              jw)
    for bad in (dict(m=3000), dict(variant=BloomVariant.BLOCKED, B=500),
                dict(variant=BloomVariant.BLOCKED, m=1 << 10, B=1 << 11)):
        with pytest.raises(ValueError):
            BloomArgs(**bad)


def test_geometry_matches_jax():
    """geometry / geometry_raw over variants, filter sizes and blocks,
    including the flagship (13 bits: two passes) and the oversized block."""
    for variant in BloomVariant:
        for m in (1 << 12, 1 << 16, 1 << 22, 1 << 27, 1 << 30, 1 << 37):
            for B in (32, 512, 1 << 17, 1 << 18):
                if B > m:
                    continue
                args = BloomArgs(variant=variant, m=m, k=2, B=B)
                assert bloom_pallas.geometry_raw(args) == \
                    jbloom_pallas.geometry_raw(_jargs(args)), args
                assert bloom_pallas.geometry(args) == \
                    jbloom_pallas.geometry(_jargs(args)), args
    flagship = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=1, B=512)
    assert bloom_pallas.geometry(flagship) is None
    assert bloom_pallas.geometry_raw(flagship) == (13, 21)
    big = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 26, k=2, B=1 << 18)
    assert bloom_pallas.geometry_raw(big) is None


def test_probe_prune_twin_keeps_what_the_filter_holds():
    """The plain prune keeps exactly the non-PAD keys the filter contains,
    in place, writes only its share of a larger output, and counts them."""
    add = _keys(4, 3000)
    s = np.concatenate([add[:1000], _keys(5, 3000)])
    s[::7] = PAD
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 15, k=3, B=256)
    words = bloom.build_bitmap(torch.from_numpy(add), args)
    out = torch.full((len(s) + 128,), 5, dtype=torch.int32)
    got, n = bloom_pallas.bloom_probe_prune(words, torch.from_numpy(s), args,
                                            out=out)
    keep = native.ref_bloom("blocked", args.m, args.k, args.B, args.seed, add,
                            s) & (s != PAD)
    assert got is out and int(n) == int(keep.sum())
    assert np.array_equal(out[:len(s)].numpy(), np.where(keep, s, PAD))
    assert (out[len(s):] == 5).all()
    with pytest.raises(ValueError):
        bloom_pallas.bloom_probe_prune(words, torch.from_numpy(s[:5]), args)


def _survivors(keys) -> np.ndarray:
    keys = np.asarray(keys).ravel()
    return np.sort(keys[keys != PAD])


@pytest.mark.parametrize("two_pass", [False, True])
def test_plan_bloom_prune_matches_jax(monkeypatch, two_pass):
    """One hash pass (m = 2^22: 5 bits) and, with MAX_PART_BITS lowered to
    2 in both packages, two (b1 = 2, b2 = 3): the port's prune keeps the
    JAX Pallas prune's survivor multiset and count, which are the
    reference filter's."""
    if two_pass:
        monkeypatch.setattr(bloom_pallas, "MAX_PART_BITS", 2)
        monkeypatch.setattr(jbloom_pallas, "MAX_PART_BITS", 2)
    rng = np.random.default_rng(17)
    rk = rng.permutation(np.arange(1, 4001)).astype(np.int32)
    sk = rng.integers(1, 30000, 10000).astype(np.int32)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 22, k=2, B=512)
    plan = bloom_pallas.plan_bloom_prune(rk, sk, args, device="cpu",
                                         chunk_rows=16)
    assert (plan.pass2 is not None) == two_pass
    assert plan.pgeom.part_bits == (2 if two_pass else 5)
    jplan = jbloom_pallas.plan_bloom_prune(jnp.asarray(rk), jnp.asarray(sk),
                                           _jargs(args), interpret=True,
                                           chunk_rows=16)
    jpruned, jn = jplan.prune_fn(jnp.int32(0))
    want = np.sort(sk[native.ref_bloom("blocked", args.m, args.k, args.B,
                                       args.seed, rk, sk)])
    assert plan.s_after == int(jn) == len(want)
    assert np.array_equal(_survivors(plan.out), _survivors(jpruned))
    assert np.array_equal(_survivors(plan.out), want)
    # the planned buffer is rewritten in place with the same layout
    before = plan.out.clone()
    out, n = plan.prune()
    assert out is plan.out and int(n) == plan.s_after
    assert torch.equal(before, plan.out)
    assert list(plan.phase_fns()) == ["bloom_build", "bloom_partition",
                                      "bloom_probe"]


def _keys_of_bucket(args, bucket, bits, n, seed):
    """n keys whose block index has top `bits` bits equal to `bucket`."""
    hash_bits = (args.nblocks - 1).bit_length()
    cand = torch.from_numpy(_keys(seed, 64 * n))
    cand = cand[cand != PAD_KEY]
    block = hashes.hash_crc(args.seed, cand) & ((1 << hash_bits) - 1)
    return cand[(block >> (hash_bits - bits)) == bucket][:n].numpy()


@pytest.mark.parametrize("case", ["run_fills_chunk", "hot_key",
                                  "oversized_block"])
def test_plan_bloom_prune_past_the_tpu_limits(monkeypatch, case):
    """Where the JAX planner declines its Pallas prune (a pass-1 run filling
    a chunk, a block past a slice) the port prunes through its kernel path
    all the same: pass 2 over a chunk-wide window, pass 1's order for a
    skewed S, whole-block partitions for an oversized block.  The survivor
    multiset and count are the reference filter's and the plain prune's."""
    chunk_rows = 8
    chunk = chunk_rows * 128
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 22, k=2, B=512)
    rng = np.random.default_rng(23)
    if case == "oversized_block":
        args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 26, k=2,
                         B=1 << 18)
        sk = _keys(24, 4 * chunk)
    else:
        # b1 = 2, b2 = 3 over the 13 block bits: chunk 0 holds one
        # pass-1 bucket, or one key fills three chunks of four
        monkeypatch.setattr(bloom_pallas, "MAX_PART_BITS", 2)
        sk = _keys(24, 4 * chunk)
        if case == "run_fills_chunk":
            sk[:chunk] = _keys_of_bucket(args, 1, 2, chunk, 25)
        else:
            sk[:3 * chunk] = sk[5]
    rk = np.concatenate([rng.choice(sk, 2000), _keys(26, 3000)])
    plan = bloom_pallas.plan_bloom_prune(rk, sk, args, device="cpu",
                                         chunk_rows=chunk_rows)
    if case == "run_fills_chunk":
        assert plan.pass2 is not None and plan.pass2.c1_rows == chunk_rows
    elif case == "hot_key":
        assert plan.pass2 is None and plan.pgeom.part_bits == 2
    else:
        assert plan.pass2 is None and plan.pgeom.part_bits == 8
    want = sk[native.ref_bloom("blocked", args.m, args.k, args.B, args.seed,
                               rk, sk)]
    mask, n = bloom_join.bloom_prune(torch.from_numpy(rk),
                                     torch.from_numpy(sk), args)
    assert plan.s_after == int(n) == len(want)
    assert np.array_equal(_survivors(plan.out), np.sort(want))
    assert np.array_equal(np.sort(sk[mask.numpy()]), np.sort(want))


def test_bloom_prune_matches_jax():
    rk, sk = _keys(6, 4000), _keys(7, 30000)
    sk[:3000] = rk[:3000]
    sp = np.arange(len(sk), dtype=np.int32)
    rp = np.arange(len(rk), dtype=np.int32) * 3
    for variant in BloomVariant:
        args = BloomArgs(variant=variant, m=1 << 17, k=4, B=1024)
        mask, n = bloom_join.bloom_prune(torch.from_numpy(rk),
                                         torch.from_numpy(sk), args)
        jmask, jn = jbloom_join.bloom_prune(jnp.asarray(rk), jnp.asarray(sk),
                                            _jargs(args))
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
        assert int(n) == int(jn)
        got = bloom_join.bloom_radix_count(
            *map(torch.from_numpy, (rk, rp, sk, sp)), args)
        want = jbloom_join.bloom_radix_count(
            *map(jnp.asarray, (rk, rp, sk, sp)), _jargs(args))
        assert [int(x) for x in got] == [int(x) % 2**32 if i in (1, 2)
                                         else int(x)
                                         for i, x in enumerate(want)]


def _workload(nonunique=False):
    rng = np.random.default_rng(9)
    if nonunique:
        rk = rng.integers(1, 3000, 6000).astype(np.int32)
    else:
        rk = rng.permutation(np.arange(1, 4097)).astype(np.int32)
    rp = rng.integers(0, 2**31 - 1, len(rk)).astype(np.int32)
    sk = rng.integers(1, 4 * 4096, 10_000).astype(np.int32)
    sp = rng.integers(0, 2**31 - 1, len(sk)).astype(np.int32)
    return rk, rp, sk, sp


BLOCKED = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 22, k=2, B=512)
BASIC = BloomArgs(variant=BloomVariant.BASIC, m=1 << 16, k=3)


# The chunk rows of the JAX planners in the interpret-mode references of
# run_join: their tiers and plan shapes are those of the defaults (which
# interpret mode caps at 1,024 rows: one chunk of 131,072 keys), over 3
# chunks of 4,096 keys.  Most of a reference's time is XLA compiling its
# interpreted kernels, which no size changes; the small chunks cut the
# interpreted runs.
JAX_CHUNK_ROWS = 32
_JAX_PRUNES = {}


def _shared_prune(plan_fn):
    """The JAX Pallas prune planner, one plan for equal inputs: the PRO and
    PRH references prune the same S with the same filter, and an
    interpret-mode plan costs tens of seconds of compilation."""
    def plan(r_key, s_key, args, interpret=False, chunk_rows=JAX_CHUNK_ROWS):
        key = (np.asarray(r_key).tobytes(), np.asarray(s_key).tobytes(),
               repr(args), interpret, chunk_rows, jbloom_pallas.MAX_PART_BITS)
        if key not in _JAX_PRUNES:
            _JAX_PRUNES[key] = plan_fn(r_key, s_key, args,
                                       interpret=interpret,
                                       chunk_rows=chunk_rows)
        return _JAX_PRUNES[key]
    return plan


def _untimed(mp):
    """The JAX plans' phase timings, which no test reads, return 0 without
    compiling their own interpret-mode programs."""
    for cls in (jbitmap_join.RadixJoinPlan, jprho_join.PrhoPlan,
                jmultipass.TwoPassPlan):
        mp.setattr(cls, "_time", lambda self, fn: 0.0)


@contextlib.contextmanager
def _jax_small_chunks():
    """The JAX package's join and prune planners at JAX_CHUNK_ROWS, the
    prune shared among equal inputs, the phase timings skipped."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jbitmap_join, "plan_radix_join"),
                          (jprho_join, "plan_prho_join"),
                          (jprho_join, "plan_prh_join")):
            mp.setattr(mod, name, functools.partial(
                getattr(mod, name), chunk_rows=JAX_CHUNK_ROWS))
        mp.setattr(jbloom_pallas, "plan_bloom_prune",
                   _shared_prune(jbloom_pallas.plan_bloom_prune))
        _untimed(mp)
        yield


@functools.lru_cache(maxsize=None)
def _jax_join(algo, nonunique, use_pallas, basic):
    """(count, tier, sums, s_after) of the JAX run_join with a filter."""
    rk, rp, sk, sp = _workload(nonunique)
    stats = None if nonunique else JKeyStats(1, 4096, is_unique=True)
    cfg = JEngineConfig(interpret=True,
                        radix=JRadixConfig(use_pallas=use_pallas))
    with _jax_small_chunks():
        res, st, sums = jax_run_join(
            algo, JRelation.from_numpy(rk, rp, stats=stats),
            JRelation.from_numpy(sk, sp), cfg,
            _jargs(BASIC if basic else BLOCKED))
    return res.count(), st.tier, tuple(sums), res.s_after_filter


@pytest.mark.parametrize("algo,nonunique,use_kernels,basic,tier,jtier", [
    ("PRO", False, True, False, "cuda_radix", "pallas_radix"),
    ("PRO", False, True, True, "cuda_radix", "pallas_radix"),
    ("PRH", False, True, False, "cuda_prh", "pallas_prh"),
    ("PRHO", False, True, False, "cuda_prho", "pallas_prho"),
    ("PRO", True, True, False, "cuda_prho", "pallas_prho"),
    ("PRO", False, False, False, "ht", "ht"),
    ("PRH", False, False, False, "sortscan", "sortscan"),
])
def test_run_join_with_filter_matches_jax(algo, nonunique, use_kernels,
                                          basic, tier, jtier):
    """Count, checksums and S-tuples after filter equal the JAX package's
    run_join and the reference filter's survivor count; the kernel tiers
    time the filter build and the prune as phases of the join."""
    rk, rp, sk, sp = _workload(nonunique)
    args = BASIC if basic else BLOCKED
    stats = None if nonunique else KeyStats(1, 4096, is_unique=True)
    res, st, sums = run_join(
        algo, Relation.from_numpy(rk, rp, device="cpu", stats=stats),
        Relation.from_numpy(sk, sp, device="cpu"),
        EngineConfig(radix=RadixConfig(use_kernels=use_kernels)), args)
    jcount, jt, jsums, jafter = _jax_join(algo, nonunique, use_kernels, basic)
    want_after = int(native.ref_bloom(args.variant.value, args.m, args.k,
                                      args.B, args.seed, rk, sk).sum())
    assert (st.tier, jt) == (tier, jtier)
    assert res.count() == st.result == jcount
    assert sums == jsums
    assert res.s_after_filter == st.s_after_filter == jafter == want_after
    if tier.startswith("cuda"):
        kernel_prune = tier != "cuda_prho" and not basic
        prune = ["bloom_build", "bloom_partition", "bloom_probe"] \
            if kernel_prune else ["bloom_build", "bloom_probe"]
        assert list(st.phases)[:len(prune)] == prune
        assert st.build_usec == (st.phases["bloom_build"]
                                 + st.phases["r_partition"]
                                 + st.phases["build"])


@pytest.mark.parametrize("variant", ["blocked", "basic"])
def test_filtered_prho_plan_gives_the_benchmark_reference(variant):
    """BPRHO as the benchmark issues it (PRHO behind the filter, the
    order-preserving prune, tier cuda_prho) on the benchmark's generator at
    q = 0.01 gives the benchmark's plain reference exactly: count, both
    checksums and S-tuples after filter."""
    from joinbench import datagen, reference

    filt = {"variant": variant, "m": 1 << 18, "k": 1, "B": 512, "seed": 42}
    config = {"r_size": 1 << 14, "s_size": 1 << 17, "nthreads": 4,
              "tuple_bytes": 8, "selectivity": 0.01, "filter": filt}
    rel = datagen.make(config, 2**31 + 5, "cpu")
    R = Relation(key=rel.r_key, payload=rel.r_pay, stats=KeyStats(
        1, config["r_size"], is_dense_pk=True, is_unique=True))
    S = Relation(key=rel.s_key, payload=rel.s_pay)
    plan, tier = registry.plan_join(
        "PRHO", R, S, EngineConfig(allow_dense=False),
        BloomArgs(variant=BloomVariant(variant), m=filt["m"], k=1, B=512,
                  seed=42))
    assert tier == "cuda_prho"
    assert isinstance(plan.prune, bloom_join.PrunePlan)
    count, r_sum, s_sum = plan.full().tolist()
    want = reference.answers(rel, config, {"result": "sums", "filter": True})
    assert {"count": count, "r_sum": r_sum, "s_sum": s_sum,
            "s_after": plan.s_after} == want
    assert 0 < want["count"] < want["s_after"] < config["s_size"]


def test_npo_ignores_the_filter():
    rk, rp, sk, sp = _workload()
    res, st, _ = run_join("NPO", Relation.from_numpy(rk, rp, device="cpu"),
                          Relation.from_numpy(sk, sp, device="cpu"),
                          EngineConfig(), BLOCKED)
    assert st.tier == "cuda_npo" and res.s_after_filter is None
    assert res.count() == native.ref_join(rk, rp, sk, sp)[0]


def test_filtered_plan_reruns_the_prune_in_place():
    """The kernel tier's plan prunes into the join's own S buffer: full()
    rebuilds the filter and re-prunes before each join."""
    rk, rp, sk, sp = _workload()
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, 4096, is_unique=True))
    S = Relation.from_numpy(sk, sp, device="cpu")
    ranges = registry.key_ranges(R)
    plan = registry.plan_kernel_join("cuda_radix", R, S, EngineConfig(),
                                     *ranges, bloom_args=BLOCKED)
    assert isinstance(plan, registry.FilteredPlan)
    assert plan.join.sk_in.data_ptr() == plan.prune.out.data_ptr()
    want = native.ref_join(rk, rp, sk, sp)[0]
    plan.prune.out.fill_(7)            # overwritten by the next prune
    assert plan.full_count() == want
