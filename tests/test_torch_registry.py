"""PyTorch port: planner, run_join and package hygiene vs the JAX package."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.config import BloomArgs as JBloomArgs
from hwbloomradixjoin_tpu.config import EngineConfig as JEngineConfig
from hwbloomradixjoin_tpu.config import RadixConfig as JRadixConfig
from hwbloomradixjoin_tpu.data import native
from hwbloomradixjoin_tpu.models import run_join as jax_run_join
from hwbloomradixjoin_tpu.ops import bitmap_join as jbitmap_join
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch.config import (BloomArgs, EngineConfig,
                                               RadixConfig)
from hwbloomradixjoin_tpu_torch.models import registry
from hwbloomradixjoin_tpu_torch.models import run_join
from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
from port_cpu import lean_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _workload(n_r=3000, n_s=20000, hi_mult=3, seed=0):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    sk = rng.integers(1, hi_mult * n_r, n_s).astype(np.int32)
    rp = rng.integers(0, 2**31 - 1, n_r).astype(np.int32)
    sp = rng.integers(0, 2**31 - 1, n_s).astype(np.int32)
    return rk, rp, sk, sp


def test_run_join_pro_cuda_radix_tier_matches_jax(monkeypatch):
    """run_join("PRO") plans the kernel tier and counts what the JAX
    package's pallas_radix tier (interpret mode) and ref_join count.  The
    JAX plan's phase timings, which no assertion reads, compile nothing."""
    monkeypatch.setattr(jbitmap_join.RadixJoinPlan, "_time",
                        lambda self, fn: 0.0)
    rk, rp, sk, sp = _workload()
    want = native.ref_join(rk, rp, sk, sp)[0]
    jst = JKeyStats(min_key=1, max_key=3000, is_unique=True)
    jres, jstats, _ = jax_run_join(
        "PRO", JRelation.from_numpy(rk, rp, stats=jst),
        JRelation.from_numpy(sk, sp), JEngineConfig(interpret=True))
    assert jstats.tier == "pallas_radix"
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, 3000, is_unique=True))
    S = Relation.from_numpy(sk, sp, device="cpu")
    res, st, sums = run_join("PRO", R, S, EngineConfig(), inner_repeats=2)
    assert st.tier == "cuda_radix"
    assert res.count() == jres.count() == want == st.result
    assert sums == (0, 0)
    # S (20000 keys) fills a twentieth of one padded 4096-row chunk, so the
    # planner compacts survivors first
    assert list(st.phases) == ["r_partition", "build", "compact",
                               "s_partition", "probe"]
    assert all(v > 0 for v in st.phases.values())
    assert st.total_usec > 0
    assert st.build_usec == st.phases["r_partition"] + st.phases["build"]


def test_run_join_compaction_phase_and_radix_bits():
    rk, rp, sk, sp = _workload(n_r=2000, n_s=300_000, hi_mult=1000, seed=2)
    want = native.ref_join(rk, rp, sk, sp)[0]
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, 2000, is_unique=True))
    S = Relation.from_numpy(sk, sp, device="cpu")
    res, st, _ = run_join("RJ", R, S)
    assert st.tier == "cuda_radix" and res.count() == want
    assert "compact" in st.phases
    res, st, _ = run_join("PRO", R, S, EngineConfig(
        radix=RadixConfig(num_radix_bits=0)))
    assert res.count() == want


def _nonunique_workload():
    rng = np.random.default_rng(7)
    rk = rng.integers(1, 4000, 6000).astype(np.int32)
    rp = rng.integers(0, 1 << 30, 6000).astype(np.int32)
    sk = rng.integers(1, 8000, 30000).astype(np.int32)
    sp = rng.integers(0, 1 << 30, 30000).astype(np.int32)
    return rk, rp, sk, sp


@functools.lru_cache(maxsize=None)
def _jax_portable(algo):
    """(count, tier, sums) of the JAX run_join on its portable tier over
    _nonunique_workload(), computed once per algorithm and worker."""
    rk, rp, sk, sp = _nonunique_workload()
    jres, jst, jsums = jax_run_join(
        algo, JRelation.from_numpy(rk, rp), JRelation.from_numpy(sk, sp),
        JEngineConfig(radix=JRadixConfig(use_pallas=False)))
    return jres.count(), jst.tier, tuple(jsums)


@pytest.mark.parametrize("algo,tier", [("NPO", "ht"), ("PRH", "sortscan"),
                                       ("PRO", "ht"), ("NPO_st", "ht")])
def test_portable_tiers_match_jax(algo, tier):
    """ht / sortscan: counts and mod-2^32 checksums equal the JAX tiers'
    and ref_join's, with a non-unique build side."""
    rk, rp, sk, sp = _nonunique_workload()
    want, wsr, wss = native.ref_join(rk, rp, sk, sp)
    jcount, jtier, (jsr, jss) = _jax_portable(algo)
    assert jtier == tier
    res, st, (sr, ss) = run_join(
        algo, Relation.from_numpy(rk, rp, device="cpu"),
        Relation.from_numpy(sk, sp, device="cpu"),
        EngineConfig(radix=RadixConfig(use_kernels=False)))
    assert st.tier == tier
    assert res.count() == jcount == want
    assert (sr, ss) == (jsr, jss) == (wsr % 2**32, wss % 2**32)
    assert st.probe_usec > 0 and st.total_usec > 0


def test_select_tier_matches_jax():
    """The ported planner picks the JAX tier names (pallas_ -> cuda_) for
    every algorithm over unique, non-unique and wide-range build sides."""
    from hwbloomradixjoin_tpu.models import registry as jreg

    rng = np.random.default_rng(3)
    rk = rng.permutation(np.arange(1, 3001)).astype(np.int32)
    cases = [
        (KeyStats(1, 3000, is_unique=True), JKeyStats(1, 3000, is_unique=True)),
        (None, None),
        (KeyStats(1, (1 << 28) + 7, is_unique=True),
         JKeyStats(1, (1 << 28) + 7, is_unique=True)),
        (KeyStats(1, 3000, True, True), JKeyStats(1, 3000, True, True)),
    ]
    for tstats, jstats in cases:
        R = Relation.from_numpy(rk, device="cpu", stats=tstats)
        JR = JRelation.from_numpy(rk, stats=jstats)
        for name in registry.ALGORITHMS:
            for use in (True, False):
                for mat in (False, True):
                    kr = registry._key_range(R)
                    wr = kr or registry._key_range(
                        R, registry.BITMAP_MAX_SPAN, require_nonneg=True)
                    assert kr == jreg._key_range(JR)
                    got = registry.select_tier(
                        registry.ALGORITHMS[name], R, EngineConfig(
                            radix=RadixConfig(use_kernels=use),
                            materialize=mat), kr, wr)
                    want = jreg.select_tier(
                        jreg.ALGORITHMS[name], JR, JEngineConfig(
                            radix=JRadixConfig(use_pallas=use),
                            materialize=mat, interpret=True), kr, wr)
                    assert got == want.replace("pallas_", "cuda_"), (
                        name, use, mat, tstats)


@pytest.mark.parametrize("algo,tier,jtier", [
    ("PRHO", "cuda_prho", "ht"),
    ("PRH", "cuda_prh", "sortscan"),
    ("NPO", "cuda_npo", "ht"),
    ("PRO", "cuda_prho", "ht"),          # non-unique R
    ("NPO_st", "cuda_npo", "ht"),
])
def test_count_table_tiers_match_jax(algo, tier, jtier):
    """The count-table tiers over a non-unique R: count and mod-2^32
    checksums equal the JAX package's portable tier and ref_join (PRH moves
    no S payload, so its S checksum is 0); NPO reports no partition time."""
    rk, rp, sk, sp = _nonunique_workload()
    want = native.ref_join(rk, rp, sk, sp)
    jcount, jst_tier, jsums = _jax_portable(algo)
    assert jst_tier == jtier
    res, st, sums = run_join(algo, Relation.from_numpy(rk, rp, device="cpu"),
                             Relation.from_numpy(sk, sp, device="cpu"))
    assert st.tier == tier
    assert res.count() == st.result == jcount == want[0]
    assert sums[0] == jsums[0] == want[1] % 2**32
    assert sums[1] == (0 if algo == "PRH" else jsums[1]) \
        == (0 if algo == "PRH" else want[2] % 2**32)
    ph = st.phases
    assert list(ph) == ["r_partition", "build", "s_partition", "probe"]
    assert st.build_usec == ph["r_partition"] + ph["build"]
    if tier == "cuda_npo":
        assert st.part_usec == 0.0
        assert st.probe_usec == ph["s_partition"] + ph["probe"]
    else:
        assert (st.part_usec, st.probe_usec) == (ph["s_partition"],
                                                 ph["probe"])
    assert st.total_usec > 0


@pytest.mark.parametrize("algo,tier", [("PRHO", "ht"), ("PRH", "sortscan"),
                                       ("NPO", "ht")])
def test_multiplicity_guard_falls_back(algo, tier):
    """70,000 copies of one key: the planner declines and run_join falls
    back to the JAX package's tier for the algorithm, with exact sums."""
    rk = np.concatenate([np.full(70000, 5, np.int32),
                         np.arange(1, 1000, dtype=np.int32)])
    rp = np.arange(len(rk), dtype=np.int32)
    sk = np.arange(-5, 1200, dtype=np.int32)
    sp = np.arange(len(sk), dtype=np.int32) * 7
    want = native.ref_join(rk, rp, sk, sp)
    res, st, sums = run_join(algo, Relation.from_numpy(rk, rp, device="cpu"),
                             Relation.from_numpy(sk, sp, device="cpu"))
    assert st.tier == tier and res.count() == want[0]
    assert sums == (want[1] % 2**32, want[2] % 2**32)


def test_fourteen_bit_count_span_takes_cuda_prho():
    """A key span in (2^27, 2^28] plans 14 count-partition bits, which the
    port once refused: run_join("PRHO") now takes cuda_prho there and
    returns ref_join's count and checksums."""
    rng = np.random.default_rng(9)
    rk = np.concatenate([[1, 1 << 27, (1 << 27) + 9],
                         rng.integers(1, (1 << 27) + 10, 2000)]) \
        .astype(np.int32)
    rp = rng.integers(0, 2**31 - 1, len(rk)).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 3000),
                         rng.integers(-5, (1 << 28), 3000)]).astype(np.int32)
    sp = rng.integers(0, 2**31 - 1, len(sk)).astype(np.int32)
    want = native.ref_join(rk, rp, sk, sp)
    res, st, sums = run_join("PRHO", Relation.from_numpy(rk, rp, device="cpu"),
                             Relation.from_numpy(sk, sp, device="cpu"))
    assert st.tier == "cuda_prho"
    assert res.count() == want[0]
    assert sums == (want[1] % 2**32, want[2] % 2**32)


@pytest.mark.parametrize("algo,cfg,kw", [
    ("PRO", EngineConfig(materialize=True), {}),
    ("PRO", EngineConfig(), {"key8b": True}),
    ("PRO", EngineConfig(), {"key8b": True, "bloom": True}),
    ("PRHO", EngineConfig(materialize=True), {"stats": None}),
])
def test_key8b_and_materialize_tiers_run(algo, cfg, kw):
    """KEY_8B (which raised until its tiers were ported) takes cuda_key8b
    for a unique R whose high words are zero: ref_join's count, and with a
    filter the JAX package's s_after_filter; materialization runs on the
    kernel tier, with ref_join's count and pairs, for an R declared unique
    and for one with no stats whose keys do not repeat (the planner's table
    shows it, as in the JAX package)."""
    rk, rp, sk, sp = _workload(n_r=500, n_s=2000)
    stats = kw.get("stats", KeyStats(1, 500, is_unique=True))
    R = Relation.from_numpy(rk, rp, device="cpu", stats=stats,
                            key8b=kw.get("key8b", False))
    S = Relation.from_numpy(sk, sp, device="cpu",
                            key8b=kw.get("key8b", False))
    bloom = BloomArgs(m=1 << 16) if kw.get("bloom") else None
    res, st, sums = run_join(algo, R, S, cfg, bloom)
    if not cfg.materialize:
        assert st.tier == "cuda_key8b" and sums == (0, 0)
        assert res.count() == native.ref_join(rk, rp, sk, sp)[0]
        if bloom is not None:
            jres, jst, _ = jax_run_join(
                algo, JRelation.from_numpy(
                    rk, rp, key8b=True,
                    stats=JKeyStats(1, 500, is_unique=True)),
                JRelation.from_numpy(sk, sp, key8b=True), JEngineConfig(),
                JBloomArgs(m=1 << 16))
            assert jst.tier == "key8b" and jres.count() == res.count()
            assert res.s_after_filter == jres.s_after_filter
        return
    assert st.tier == "cuda_materialize"
    rmap = dict(zip(rk.tolist(), rp.tolist()))
    want = sorted((rmap[k], p) for k, p in zip(sk.tolist(), sp.tolist())
                  if k in rmap)
    assert res.count() == len(want) == native.ref_join(rk, rp, sk, sp)[0]
    assert sorted(zip(res.r_payload.tolist(), res.s_payload.tolist())) \
        == want


@pytest.mark.parametrize("algo,cfg,kw,tier", [
    ("PRO", EngineConfig(allow_dense=False), {}, "cuda_radix"),
    ("PRO", EngineConfig(), {"bloom": True}, "cuda_radix"),
    ("PRHO", EngineConfig(), {"bloom": True}, "cuda_prho"),
    ("PRH", EngineConfig(), {}, "cuda_prh"),
    ("NPO", EngineConfig(), {"bloom": True}, "cuda_npo"),
    ("PRO", EngineConfig(materialize=True), {}, "cuda_materialize"),
    ("PRO", EngineConfig(), {"key8b": True}, "cuda_key8b"),
    ("PRO", EngineConfig(radix=RadixConfig(use_kernels=False)), {}, "ht"),
])
def test_plan_join_is_the_plan_run_join_times(algo, cfg, kw, tier):
    """plan_join, which profile.py traces, names run_join's tier and gives
    the plan whose whole join counts what run_join reports, with its phases
    and, on the radix tiers, its geometry; a plain-torch tier has no plan."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join

    rk, rp, sk, sp = _workload(n_r=500, n_s=2000)
    key8b = kw.get("key8b", False)
    R = Relation.from_numpy(rk, rp, device="cpu", key8b=key8b,
                            stats=KeyStats(1, 500, is_unique=True))
    S = Relation.from_numpy(sk, sp, device="cpu", key8b=key8b)
    bloom = BloomArgs(m=1 << 16) if kw.get("bloom") else None
    plan, got = registry.plan_join(algo, R, S, cfg, bloom)
    res, st, _ = run_join(algo, R, S, cfg, bloom)
    assert got == st.tier == tier
    assert res.count() == native.ref_join(rk, rp, sk, sp)[0]
    if plan is None:
        assert tier == "ht" and st.geometry is None
        return
    out = plan.full()
    count = out[3] if tier == "cuda_materialize" else out.reshape(-1)[0]
    assert int(count) == res.count()
    assert list(plan.phase_fns()) == list(st.phases)
    if tier in ("cuda_radix", "cuda_key8b"):
        assert st.geometry == registry.radix_geometry(plan)
        assert st.geometry[:3] == bitmap_join.plan_geometry(1, 500)
    else:
        assert st.geometry is None


def test_dense_gate_needs_a_cuda_tensor():
    """A declared dense PK goes to the dense tier only on the card; on the
    CPU the planner keeps the kernel tier (whose twins run there)."""
    rk, rp, _, _ = _workload(n_r=500)
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, 500, True, True))
    spec = registry.ALGORITHMS["PRO"]
    assert registry.select_tier(spec, R, EngineConfig(), (1, 500)) \
        == "cuda_radix"


_HYGIENE = """
import json, sys
import hwbloomradixjoin_tpu_torch as pkg
from hwbloomradixjoin_tpu_torch import bench
from hwbloomradixjoin_tpu_torch.data import generator as G
from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.models import run_join
from hwbloomradixjoin_tpu_torch.types import Relation
p = G.WorkloadParams(r_size=2000, s_size=40000, nthreads=4, selectivity=0.5)
rk, rp, sk, sp = G.build_workload(p)
S = Relation.from_numpy(sk, sp, device="cpu")
res, st, _ = run_join("PRO", Relation.from_numpy(rk, rp, device="cpu",
                                                 stats=G.r_key_stats(p)), S)
prho = run_join("PRHO", Relation.from_numpy(rk, rp, device="cpu"), S)
rec = bench.run_bench("cpu", 2000, 40000, selectivity=0.01, repeats=1, inner=1)
from hwbloomradixjoin_tpu_torch import cli, confrun, unittests
from hwbloomradixjoin_tpu_torch.data import tblio
from hwbloomradixjoin_tpu_torch.utils import profiling, roofline
from hwbloomradixjoin_tpu_torch.ops import aggregate, sort
from hwbloomradixjoin_tpu_torch.parallel import dist_join, mesh, multiproc
from hwbloomradixjoin_tpu_torch.parallel import skew
cli.main(["-r", "2000", "-s", "10000", "--key8b", "-z", "0.5", "--verbose",
          "--engine-backend", "cpu"])
cli.main(["-r", "2000", "-s", "10000", "--engine-devices", "1",
          "--engine-local-join", "pallas", "--engine-backend", "cpu"])
print(json.dumps({"jax": [m for m in sys.modules
                          if m in ("jax", "hwbloomradixjoin_tpu")
                          or m.startswith(("jax.", "hwbloomradixjoin_tpu."))],
                  "loaded": _build.is_loaded(), "build": _build.build_info,
                  "launches": _build.LAUNCHES, "tier": st.tier,
                  "count": res.count(), "bench": rec,
                  "prho": [prho[1].tier, prho[0].count(), prho[2]]}))
"""


def test_package_imports_no_jax_builds_nothing_on_cpu():
    """In a fresh process: the port and CPU runs of it (PRO on the radix
    tier, PRHO on the count-table tier, the CLI over 16-byte tuples and a
    Zipf S, and its distributed join of one device on the bitmap engine)
    import no jax and no JAX package, build and load no kernel, and count
    no launches."""
    out = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["jax"] == []
    assert got["loaded"] is False and got["build"] == {}
    assert set(got["launches"].values()) == {0}
    assert got["tier"] == "cuda_radix" and got["count"] == 20000
    from hwbloomradixjoin_tpu_torch.data import generator as G
    rk, rp, sk, sp = G.build_workload(G.WorkloadParams(
        r_size=2000, s_size=40000, nthreads=4, selectivity=0.5))
    want = native.ref_join(rk, rp, sk, sp)
    assert got["prho"] == ["cuda_prho", 20000,
                           [want[1] % 2**32, want[2] % 2**32]]
    assert got["bench"]["value"] > 0 and got["bench"]["unit"] == "rows/s"
    assert "tier=cuda_radix" in got["bench"]["metric"]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda.is_available() is false, and in a directory holding only
    itself."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(open(script).read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if not torch.cuda.is_available():
        assert "is_available() is false" in out.stderr


def test_print_timing_matches_jax():
    """The reference's stdout timing block, byte for byte."""
    from hwbloomradixjoin_tpu.utils.timing import JoinStats as JJoinStats
    from hwbloomradixjoin_tpu.utils.timing import print_timing as jprint
    from hwbloomradixjoin_tpu_torch.utils.timing import JoinStats, print_timing

    kw = dict(total_usec=7404.25, build_usec=781.5, part_usec=6004.8,
              probe_usec=788.2, result=128_000_000, num_s_tuples=128_000_000,
              s_after_filter=None)
    for extra in ({}, {"s_after_filter": 1_280_000}):
        want = jprint(JJoinStats(**{**kw, **extra}))
        got = print_timing(JoinStats(**{**kw, **extra}))
        assert got == want
    assert JoinStats(**kw).nsec_per_tuple == JJoinStats(**kw).nsec_per_tuple
