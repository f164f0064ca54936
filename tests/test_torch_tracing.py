"""PyTorch port: the program's spans and its host-read counter.

``utils/profiling.py`` on the CPU at tiny sizes: the span tree of
``registry.plan_join`` and the plan's ``full()`` on the paths the
benchmark's cells take (PRO at q = 1 and q = 0.01, PRO behind a blocked
filter pruned in two hash passes, PRHO, PRHO behind the order-preserving
prune) as a CPU profiler sees it, the host reads each step makes, and what
spans do with no profiler running and inside ``profiling.trace()``.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                               EngineConfig)
from hwbloomradixjoin_tpu_torch.models import registry
from hwbloomradixjoin_tpu_torch.ops import bloom_pallas
from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
from hwbloomradixjoin_tpu_torch.utils import profiling

N_R = 3000
PHASES = ["hbrj.r_partition", "hbrj.build", "hbrj.s_partition",
          "hbrj.probe"]
COMPACTED = ["hbrj.r_partition", "hbrj.build", "hbrj.compact",
             "hbrj.s_partition", "hbrj.probe"]
PRUNE = ["hbrj.bloom_build", "hbrj.bloom_partition", "hbrj.bloom_probe"]
ORDERED = ["hbrj.bloom_build", "hbrj.bloom_probe"]


def _leaves(*names):
    return [(n, []) for n in names]


# path -> (algorithm, |S|, S's key range, filter, plan_join's children,
# full()'s children, host reads by span)
PATHS = {
    # S fills over half of its one padded chunk: no compaction
    "cuda_radix.q1": ("PRO", 300_000, N_R, None,
                      _leaves("hbrj.plan.pad_s", "hbrj.plan.survivor_count",
                              "hbrj.plan.pad_r"),
                      _leaves(*PHASES),
                      {"hbrj.plan.survivor_count": 1}),
    "cuda_radix.q001": ("PRO", 20_000, 100 * N_R, None,
                        _leaves("hbrj.plan.pad_s",
                                "hbrj.plan.survivor_count",
                                "hbrj.plan.compact_cap", "hbrj.plan.pad_r"),
                        _leaves(*COMPACTED),
                        {"hbrj.plan.survivor_count": 1,
                         "hbrj.plan.compact_cap": 1}),
    "cuda_radix.bloom_2pass": (
        "PRO", 20_000, 100 * N_R,
        BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 22, k=1, B=512),
        _leaves("hbrj.plan.pad_s", "hbrj.plan.pass2_geometry",
                "hbrj.plan.prune_out")
        + [("hbrj.plan.prune", _leaves(*PRUNE))]
        + _leaves("hbrj.plan.pad_s", "hbrj.plan.survivor_count",
                  "hbrj.plan.compact_cap", "hbrj.plan.pad_r"),
        _leaves(*PRUNE, *COMPACTED),
        {"hbrj.plan.pass2_geometry": 1, "hbrj.plan.prune": 1,
         "hbrj.plan.survivor_count": 1, "hbrj.plan.compact_cap": 1}),
    # PRHO behind the filter: the order-preserving prune keeps S's
    # payloads beside its keys, and the join is planned over its buffer
    "cuda_prho.bloom": (
        "PRHO", 20_000, 100 * N_R,
        BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 22, k=1, B=512),
        _leaves("hbrj.plan.prune_out")
        + [("hbrj.plan.prune", [("hbrj.ordered_prune", _leaves(*ORDERED))])]
        + _leaves("hbrj.plan.pad_s", "hbrj.plan.pad_r", "hbrj.plan.pad_s")
        + [("hbrj.plan.multiplicity_guard",
            _leaves("hbrj.r_partition", "hbrj.build", "hbrj.s_partition"))],
        [("hbrj.ordered_prune", _leaves(*ORDERED))] + _leaves(*PHASES),
        {"hbrj.plan.prune": 1, "hbrj.plan.multiplicity_guard": 1}),
    "cuda_prho": ("PRHO", 20_000, N_R, None,
                  _leaves("hbrj.plan.pad_r", "hbrj.plan.pad_s")
                  + [("hbrj.plan.multiplicity_guard",
                      _leaves("hbrj.r_partition", "hbrj.build",
                              "hbrj.s_partition"))],
                  _leaves(*PHASES),
                  {"hbrj.plan.multiplicity_guard": 1}),
}


def _relations(n_s: int, s_hi: int):
    rng = np.random.default_rng(n_s + s_hi)
    rk = rng.permutation(np.arange(1, N_R + 1)).astype(np.int32)
    sk = rng.integers(1, s_hi + 1, n_s).astype(np.int32)
    R = Relation.from_numpy(rk, rk, device="cpu", stats=KeyStats(
        1, N_R, is_dense_pk=True, is_unique=True))
    return R, Relation.from_numpy(sk, sk, device="cpu")


@pytest.fixture
def query(monkeypatch):
    """path -> a function that plans and runs that path's query once:
    (plan, tier, the count)."""
    # the blocked filter's 5 hash bits take two passes past 2 bits
    monkeypatch.setattr(bloom_pallas, "MAX_PART_BITS", 2)

    def make(path):
        algo, n_s, s_hi, bloom = PATHS[path][:4]
        R, S = _relations(n_s, s_hi)

        def run():
            plan, tier = registry.plan_join(algo, R, S, EngineConfig(
                allow_dense=False), bloom)
            return plan, tier, int(plan.full().reshape(-1)[0])
        return run
    return make


CPU = [torch.profiler.ProfilerActivity.CPU]


def _profiled(fn):
    """(fn's value, the program's spans): root spans as (name, children)
    trees in the order they opened, and each host read's innermost span
    (None outside every span)."""
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()

    def program_parent(ev):
        ev = ev.cpu_parent
        while ev is not None and not ev.name.startswith("hbrj."):
            ev = ev.cpu_parent
        return ev

    kids: dict = {}
    reads = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not ev.name.startswith("hbrj."):
            continue
        parent = program_parent(ev)
        if ev.name == profiling.READ_MARK:
            reads.append(None if parent is None else parent.name)
        else:
            kids.setdefault(None if parent is None else parent.id,
                            []).append(ev)

    def node(ev):
        return ev.name, [node(k) for k in kids.get(ev.id, [])]
    return out, SimpleNamespace(tree=[node(ev) for ev in kids.get(None, [])],
                                reads=reads)


def _reads_by_name(reads) -> dict:
    out: dict = {}
    for name in reads:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_span_tree_and_host_reads(path, query):
    """plan_join's and full()'s spans nest as the path plans and runs; each
    host read is marked inside its step, and the counter counts the same
    reads."""
    run = query(path)
    plan_kids, full_kids, reads = PATHS[path][4:]
    before = profiling.HOST_READS

    def twice():
        plan, tier, count = run()
        plan.full()
        return tier, count
    (tier, count), seen = _profiled(twice)
    assert tier == path.split(".")[0] and count > 0
    assert seen.tree == [("hbrj.plan_join", plan_kids),
                         ("hbrj.full", full_kids),
                         ("hbrj.full", full_kids)]
    assert _reads_by_name(seen.reads) == reads
    assert profiling.HOST_READS - before == sum(reads.values())


def test_reads_outside_spans_are_marked_at_the_top(query):
    run = query("cuda_radix.q1")

    def two():
        run()
        run()
        return profiling.host_read(torch.ones(()))
    got, seen = _profiled(two)
    assert got == 1.0
    assert [name for name, _ in seen.tree] == [
        "hbrj.plan_join", "hbrj.full", "hbrj.plan_join", "hbrj.full"]
    assert seen.reads == ["hbrj.plan.survivor_count",
                          "hbrj.plan.survivor_count", None]


def test_spans_off_enter_no_profiler(query, monkeypatch):
    """With no profiler running, span() is one shared no-op that never
    enters record_function; host reads still count."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run = query("cuda_radix.q001")
    before = profiling.HOST_READS
    run()
    assert profiling.span("hbrj.a") is profiling.span("hbrj.b")
    assert profiling.HOST_READS - before == 2


def test_host_read_returns_host_values():
    assert profiling.host_read(torch.tensor(7)) == 7
    assert profiling.host_read(torch.tensor(True)) is True
    got = profiling.host_read(torch.arange(3))
    assert got.device.type == "cpu" and got.tolist() == [0, 1, 2]


def test_spans_go_off_when_the_profiler_stops(query, monkeypatch):
    run = query("cuda_radix.q1")
    _, seen = _profiled(run)
    assert [name for name, _ in seen.tree] == ["hbrj.plan_join", "hbrj.full"]

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered after the profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run()
    assert profiling.span("hbrj.a") is profiling.span("hbrj.b")


@pytest.mark.parametrize("path", ["cuda_radix.q001", "cuda_prho",
                                  "cuda_prho.bloom"])
def test_phase_fns_run_in_their_spans(path, query):
    """Each phase a plan times on its own runs in the span of the same
    name as in full(), so the planning run and the timed run agree."""
    plan, _, _ = query(path)()
    fns = plan.phase_fns()
    for name, fn in fns.items():
        _, seen = _profiled(fn)
        assert seen.tree == [("hbrj." + name, [])]


def test_trace_writes_spans(query, tmp_path):
    """profiling.trace() writes the program's spans and read marks into
    its Chrome trace."""
    run = query("cuda_prho")
    with profiling.trace(str(tmp_path)) as logdir:
        run()
    assert logdir == str(tmp_path)
    (path,) = tmp_path.glob("trace_*.json")
    names = {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"hbrj.plan_join", "hbrj.plan.multiplicity_guard", "hbrj.full",
            "hbrj.probe", profiling.READ_MARK} <= names
