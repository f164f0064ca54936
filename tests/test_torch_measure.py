"""PyTorch port: the measurement harness and the validation tools.

The port's JoinConfig and parse_result against the repository's
measurements/ harness, the sweep driver's saving (no pandas) and resume
guard, the full-span workload against tools/validate_fullrange.py, the
full-span PRO plan on the CPU twins against native.ref_join and the JAX
package's XLA tier, and the survivor theory the validation tools hold the
filter to.
"""

import importlib.util
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.config import EngineConfig as JEngineConfig
from hwbloomradixjoin_tpu.config import RadixConfig as JRadixConfig
from hwbloomradixjoin_tpu.models import run_join as jax_run_join
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch import cli
from hwbloomradixjoin_tpu_torch.config import EngineConfig
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.measurements import run
from hwbloomradixjoin_tpu_torch.measurements.config import JoinConfig
from hwbloomradixjoin_tpu_torch.models import registry
from hwbloomradixjoin_tpu_torch.ops import bitmap_join, bloom
from hwbloomradixjoin_tpu_torch.tools import validate_fullrange as VF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "measurements"))
from measurements.config import JoinConfig as JJoinConfig  # noqa: E402
from measurements.run import parse_result as jparse_result  # noqa: E402
from port_cpu import lean_cpu  # noqa: E402,F401  (autouse)

# tests/test_harness.py:44-55's sample
SAMPLE = (
    "[INFO ] Creating relation R with size = 0.763 MiB, #tuples = 100000 : OK \n"
    "[INFO ] Creating relation S with size = 3.052 MiB, #tuples = 400000 : OK \n"
    "[INFO ] Running join algorithm PRO ...\n"
    "S-tuples after filter: 109229\n"
    "RUNTIME TOTAL, BUILD, PART (cycles): \n"
    "13777668 \t 1429536 \t 0 \n"
    "TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE: \n"
    "6562.0000 \t 100000 \t 16.4050 \n"
    "PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS: \n"
    "0.0000 \t 5881.0000\t 6562.0000 \n"
    "[INFO ] Results = 100000. DONE.\n")

CONFIGS = [
    {},
    {"bloom_filter": "blocked", "bloom_size": 1 << 27, "bloom_hashes": 4,
     "selectivity": 0.01},
    {"bloom_filter": "basic", "bloom_size": 1 << 20, "bloom_hashes": 3,
     "bloom_block_size": 1024},
    {"full_range": True, "non_unique": True, "r_size": 1 << 24},
    {"radix_bits": 12, "passes": 2, "no_dense": True, "inner": 4},
    {"devices": 4, "local_join": "pallas", "repeats": 3},
    {"devices": 1, "local_join": "sortscan", "backend": "cpu"},
    {"backend": "cuda", "use_pallas": False, "skew": 1.25, "threads": 4,
     "r_seed": 7, "s_seed": 8},
]


@pytest.mark.parametrize("fields", CONFIGS)
def test_join_config_args_are_the_harness_s(fields):
    """to_args() gives the repository harness's arguments, every one of
    which the port's CLI takes with the configuration's values; cmdline()
    names the port's CLI."""
    cfg = JoinConfig(**fields)
    args = cfg.to_args()
    assert args == JJoinConfig(**fields).to_args()
    assert cfg.cmdline().startswith(
        "python -m hwbloomradixjoin_tpu_torch.cli -a ")
    a = cli.build_parser().parse_args(args)
    assert (a.algo, a.r_size, a.s_size, a.s_sel, a.skew) == (
        cfg.algorithm, cfg.r_size, cfg.s_size, cfg.selectivity, cfg.skew)
    assert (a.bloom_filter, a.non_unique, a.full_range) == (
        cfg.bloom_filter, cfg.non_unique, cfg.full_range)
    if cfg.bloom_filter != "no":
        assert (a.bloom_size, a.bloom_hashes, a.bloom_block_size) == (
            cfg.bloom_size, cfg.bloom_hashes, cfg.bloom_block_size)
    assert (a.engine_radix_bits, a.engine_passes, a.engine_backend) == (
        cfg.radix_bits, cfg.passes, cfg.backend)
    assert (a.engine_devices, a.engine_local_join) == (
        cfg.devices, cfg.local_join)
    assert (a.engine_no_pallas, a.engine_no_dense) == (
        not cfg.use_pallas, cfg.no_dense)
    assert (a.engine_inner, a.engine_repeats) == (cfg.inner, cfg.repeats)


def test_parse_result_is_the_harness_s(capsys):
    """The same dict as measurements/run.py's on the harness's sample and
    on the port CLI's own stdout (a filtered join on the CPU)."""
    assert run.parse_result(SAMPLE) == jparse_result(SAMPLE)
    argv = ["-a", "PRO", "-r", "1000", "-s", "4000", "-q", "0.5", "-b",
            "blocked", "-m", "65536", "-k", "2", "-B", "512",
            "--engine-no-pallas", "--engine-backend", "cpu",
            "--engine-sync-stats"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    got = run.parse_result(out)
    assert got == jparse_result(out)
    assert got["results"] == got["out-tuples"] == 2000
    assert 2000 <= got["filtered"] < 4000
    assert run.parse_sync(out)["tier"] == "ht"


def test_parse_result_counts_an_empty_filter():
    """A filter that keeps nothing gives filtered-pct 0.0 (the harness's
    truthiness test gives None); no filter line gives None."""
    empty = SAMPLE.replace("S-tuples after filter: 109229",
                           "S-tuples after filter: 0")
    assert run.parse_result(empty)["filtered-pct"] == 0.0
    assert jparse_result(empty)["filtered-pct"] is None
    plain = SAMPLE.replace("S-tuples after filter: 109229\n", "")
    assert run.parse_result(plain)["filtered-pct"] is None
    assert run.parse_result(SAMPLE)["filtered-pct"] == 109229 / 400000 * 100


def _fake_run_one(calls):
    def fake(cfg, timeout=0, env=None):
        calls.append(cfg)
        return {**run.dataclasses.asdict(cfg), "results": cfg.s_size,
                "time-usecs": 1.5, "tier": "cuda_radix", "exact": True,
                "phases": {"probe": 1.0}}
    return fake


def test_sweep_saves_without_pandas(monkeypatch, tmp_path):
    """save_data writes JSON lines and a markdown table with pandas
    blocked, and load_rows reads the rows back."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    calls = []
    monkeypatch.setattr(run, "run_one", _fake_run_one(calls))
    rows = run.sweep_passes(backend="cpu", out_dir=tmp_path)
    assert [c.passes for c in calls] == [1, 2]
    assert [r["passes"] for r in rows] == [1, 2]
    assert run.load_rows("passes", tmp_path) == json.loads(json.dumps(rows))
    md = (tmp_path / "passes.md").read_text().splitlines()
    assert md[0].startswith("| algorithm | threads |") and len(md) == 4
    assert "| 1.5 |" in md[2]


def test_resume_skips_only_an_equal_config(monkeypatch, tmp_path, capsys):
    """A resumed sweep skips the jobs whose whole JoinConfig equals a saved
    row's, with a line saying so, and runs one that differs in a single
    field (sweep_algos' guard matched on r_size alone)."""
    calls = []
    monkeypatch.setattr(run, "run_one", _fake_run_one(calls))
    base = JoinConfig(algorithm="PRO", r_size=1000, s_size=4000)
    run.run_sweep("resume", [(base, {"n": 0})], tmp_path, resume=True)
    other = JoinConfig(algorithm="PRO", r_size=1000, s_size=4000, s_seed=1)
    rows = run.run_sweep("resume", [(JoinConfig(**run.dataclasses.asdict(
        base)), {"n": 1}), (other, {"n": 2})], tmp_path, resume=True)
    assert calls == [base, other]
    assert [r["n"] for r in rows] == [0, 2]
    assert "resume resume: python -m hwbloomradixjoin_tpu_torch.cli" \
        in capsys.readouterr().out
    calls.clear()
    run.run_sweep("resume", [(base, {})], tmp_path)     # no resume: reruns
    assert calls == [base] and len(run.load_rows("resume", tmp_path)) == 1


def test_radix_bits_sweep_runs_only_planned_widths(monkeypatch, tmp_path):
    """At workload B PRO plans at most 15 bits and PRHO at least 13: the
    sweep runs PRO 12-15 and PRHO 13-17 under their own numbers, and the
    planner's own choice only where it is a width not yet run."""
    calls = []
    monkeypatch.setattr(run, "run_one", _fake_run_one(calls))
    rows = run.sweep_radix_bits(backend="cpu", out_dir=tmp_path)
    got = [(r["algorithm"], r["radix-bits"], r["plan-bits"]) for r in rows]
    assert [g for g in got if g[1] != -1] == \
        [("PRO", b, b) for b in range(12, 16)] \
        + [("PRHO", b, b) for b in range(13, 18)]
    assert all(c.radix_bits == r["plan-bits"] for c, r in zip(calls, rows))
    assert len({(a, p) for a, _, p in got}) == len(got)
    assert run.plan_bits("PRO", run.WORKLOAD_B, 17) == 15
    assert run.plan_bits("PRHO", run.WORKLOAD_B, 12) == 13


@pytest.mark.parametrize("sweep", ["scaling", "dist_bloom"])
def test_world_sweeps_take_the_backend(monkeypatch, tmp_path, sweep):
    """scaling and dist_bloom run their gloo ranks where --engine-backend
    says: on the CPU for cpu, each row saying so; on the card otherwise,
    which raises here, before any rank starts."""
    from hwbloomradixjoin_tpu_torch.parallel import multiproc

    worlds = []

    def fake_world(nproc, cases, device, backend, timeout):
        worlds.append((nproc, device, backend))
        return {"results": [{"n_dev": c["n_dev"], "outputs": [5, 0, 0, 7, 0],
                             "seconds": 1.0} for c in cases]}

    monkeypatch.setattr(multiproc, "run_world", fake_world)
    monkeypatch.setattr(multiproc, "expected", lambda c: (5, 0, 0, 7))
    assert run.main([sweep, "--engine-backend", "cpu", "--out",
                     str(tmp_path)]) == 0
    assert worlds == [(8, "cpu", "gloo")]
    rows = run.load_rows(sweep, tmp_path)
    assert rows and all(r["ranks-on"] == "cpu" and r["exact"] for r in rows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([sweep, "--engine-backend", "cuda", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(run, f"sweep_{sweep}")(backend="auto", out_dir=tmp_path)
    assert len(worlds) == 1


def test_group_by_zipf_counts_the_host_s_groups():
    """The zipf sweep's in-process group_by_key over the CLI's Zipf S."""
    cfg = JoinConfig(r_size=1000, s_size=5000, skew=1.25)
    got = run.group_by_zipf(cfg, torch.device("cpu"))
    from hwbloomradixjoin_tpu_torch.data import generator as G
    _, _, sk, _ = G.build_workload(G.WorkloadParams(
        r_size=1000, s_size=5000, nthreads=8, skew=1.25))
    assert got["groups"] == len(np.unique(sk))
    assert got["hot-share"] == np.bincount(sk).max() / 5000
    assert got["group-by-ms"] >= 0
    assert run.expected_count(cfg) == 5000
    assert run.expected_count(JoinConfig(s_size=1000, selectivity=0.25)) \
        == 250
    assert run.expected_count(JoinConfig(non_unique=True)) is None


def _jax_tool():
    """tools/validate_fullrange.py, imported by path (it imports JAX only
    inside main); the environment it sets at import is put back."""
    spec = importlib.util.spec_from_file_location(
        "jax_validate_fullrange",
        os.path.join(REPO, "tools", "validate_fullrange.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ), mock.patch.object(sys, "path",
                                                        list(sys.path)):
        spec.loader.exec_module(mod)
    return mod


def test_fullrange_workload_is_the_jax_tool_s():
    """The same R and S keys as the JAX tool's build_inrange_workload, and
    the host count is numpy's membership count."""
    jtool = _jax_tool()
    rk, sk = VF.build_inrange_workload(3000, 20000, 0.01)
    jrk, jsk = jtool.build_inrange_workload(3000, 20000, 0.01)
    np.testing.assert_array_equal(rk, jrk)
    np.testing.assert_array_equal(sk, jsk)
    assert rk.dtype == sk.dtype == np.int32 and len(np.unique(rk)) == 3000
    assert VF.host_count(rk, sk) == int(np.isin(sk, rk).sum())


def test_fullrange_pro_counts_as_ref_join_and_jax():
    """PRO over the full int32 span on the CPU twins: cuda_radix, the plan
    (13, 18, 64) with R's PAD category, and the count of native.ref_join
    and of the JAX package's run_join on its XLA tier."""
    rk, sk = VF.build_inrange_workload(4000, 40000, 0.01)
    R, S = VF.relations(rk, sk, "cpu")
    lo, hi = int(rk.min()), int(rk.max())
    assert registry.select_tier(registry.ALGORITHMS["PRO"], R, EngineConfig(
        allow_dense=False), *registry.key_ranges(R)) == "cuda_radix"
    assert registry.key_ranges(R)[1] == (lo, hi)
    plan = bitmap_join.plan_radix_join(rk, sk, lo, hi, device="cpu")
    assert (plan.sgeom.part_bits, plan.sgeom.shift, plan.sl_rows) \
        == VF.FULL_SPAN_GEOMETRY and plan.rgeom.pad_cat
    want = native.ref_join(rk, np.zeros_like(rk), sk, np.zeros_like(sk))[0]
    assert plan.full_count() == want == VF.host_count(rk, sk)
    jres, jst, _ = jax_run_join(
        "PRO", JRelation.from_numpy(rk, np.arange(len(rk), dtype=np.int32),
                                    stats=JKeyStats(lo, hi, is_unique=True)),
        JRelation.from_numpy(sk, np.zeros_like(sk)),
        JEngineConfig(radix=JRadixConfig(use_pallas=False)))
    assert not jst.tier.startswith("pallas") and jres.count() == want


def test_validate_join_reads_the_timed_plan_s_geometry():
    """validate_join holds the geometry run_join's own plan reports
    (JoinStats.geometry), behind the filter too, and fails a join whose
    geometry is not the one asked for."""
    from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation

    rng = np.random.default_rng(3)
    rk = rng.permutation(np.arange(1, 501)).astype(np.int32)
    sk = rng.integers(1, 1500, 2000).astype(np.int32)
    R = Relation.from_numpy(rk, rk, device="cpu",
                            stats=KeyStats(1, 500, is_unique=True))
    S = Relation.from_numpy(sk, sk, device="cpu")
    want = VF.host_count(rk, sk)
    geom = bitmap_join.plan_geometry(1, 500)
    cfg = EngineConfig(allow_dense=False)
    ok, st, line = VF.validate_join("small", R, S, 2000, want, cfg,
                                    VF.blocked(1 << 16, 2), geom,
                                    inner_repeats=1)
    assert ok and st.geometry[:3] == geom, line
    assert f"plan={geom} pad_cat={st.geometry[3]}" in line
    bad = (geom[0], geom[1] + 1, geom[2])
    ok, _, line = VF.validate_join("small", R, S, 2000, want, cfg, None, bad,
                                   inner_repeats=1)
    assert not ok and f"plan {geom} != {bad}" in line


def test_survivor_theory_counts_accidental_members():
    """p + (1 - p) fpr with p the real match share: above the JAX tool's
    q-based theory on the full span, where a uniform key is in R with
    probability |R| / 2^31."""
    rk, sk = VF.build_inrange_workload(4000, 40000, 0.01)
    expected = VF.host_count(rk, sk)
    assert expected > 400                    # 400 drawn from R, plus chance
    m, k = 1 << 16, 2
    fpr = bloom.theoretical_fpr(m, k, 4000)
    p = expected / 40000
    got = VF.survivor_theory(expected, 40000, m, k, 4000)
    assert got == p + (1 - p) * fpr
    assert got > 0.01 + 0.99 * fpr
    assert VF.survivor_theory(400, 40000, m, k, 4000) \
        == 0.01 + 0.99 * fpr


def test_port_imports_no_jax_harness_or_tools():
    """No module of the port imports jax, the JAX package, or the
    repository's measurements/ or tools/ (the port keeps its own copies),
    or pandas; the analysis, figures, rerun module and chip tools are
    among the modules checked."""
    import ast
    import pathlib
    banned = {"jax", "jaxlib", "hwbloomradixjoin_tpu", "measurements",
              "tools", "pandas"}
    pkg = pathlib.Path(REPO, "hwbloomradixjoin_tpu_torch")
    assert {f"{d}/{m}.py" for d, m in (
        ("measurements", "analysis"), ("measurements", "plot_basics"),
        ("measurements", "rerun"), ("tools", "validate_pro"),
        ("tools", "build_check"), ("tools", "part_bench"),
        ("tools", "microbench"), ("tools", "validate_key8b"))} <= {
        p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")}
    found = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 and node.module else []
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in banned]
    assert len(list(pkg.rglob("*.py"))) > 40 and found == []
