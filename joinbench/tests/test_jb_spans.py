"""joinbench/spans.py: the program's spans in a profiled stretch, on
synthetic events and on a profiler run on the CPU."""

import pytest
import torch

from joinbench import spans
from joinbench import trace as tr

# two queries of 100 us; the first plans (a prune holding a filter build)
# and runs a probe, then reads back; the second runs nothing of the program
PROGRAM = [("hbrj.plan_join", 5, 60), ("hbrj.plan.prune", 10, 40),
           ("hbrj.bloom_build", 12, 20), ("hbrj.full", 65, 95),
           ("hbrj.probe", 70, 90)]
BENCH = [("query", 0, 100), ("query", 100, 200), ("plan", 5, 60),
         ("full", 65, 95), ("readback", 95, 100)]
MARKS = [35, 55, 150]
OPS = [(14, 18, 12.5),      # launched in the filter build
       (22, 30, 21),        # in the prune, outside the build
       (50, 58, 45),        # in plan_join itself
       (72, 85, 71),        # in the probe
       (96, 99, 96),        # in the benchmark's readback
       (100.5, 101, 100.2)]  # in no span


def test_attribution_of_device_time_idle_time_and_reads():
    att = spans.attribute(PROGRAM, MARKS, BENCH, OPS)
    assert att.queries == 2
    assert [n.name for n in att.nodes] == [p[0] for p in PROGRAM]
    assert [n.parent for n in att.nodes] == [None, 0, 1, None, 3]
    assert att.busy_us == 36.5 and att.idle_us == 163.5
    # device time under each span, its children's included
    assert att.busy_under(["hbrj.plan_join"]) == 20
    assert att.busy_under(["hbrj.plan.prune"]) == 12
    assert att.busy_under(["hbrj.bloom_build"]) == 4
    assert att.busy_under(["hbrj.full"]) == att.busy_under(
        ["hbrj.probe"]) == 13
    assert att.busy_under(["hbrj.bloom_build", "hbrj.probe"]) == 17
    assert att.busy_under(["hbrj.s_pass2"]) is None
    assert att.self_busy == {"hbrj.bloom_build": 4, "hbrj.plan.prune": 8,
                             "hbrj.plan_join": 8, "hbrj.probe": 13}
    assert att.ops["hbrj.plan_join"] == 3 and att.ops["hbrj.probe"] == 1
    # gaps cut at span edges, each piece to the innermost span open
    assert att.idle == {"hbrj.plan_join": 17, "hbrj.plan.prune": 14,
                        "hbrj.bloom_build": 4, "hbrj.full": 10,
                        "hbrj.probe": 7}
    assert att.idle_outside_us == 111.5
    assert sum(att.idle.values()) + att.idle_outside_us == att.idle_us
    # the readback's copy is held by the benchmark's span; the last is not
    assert att.unheld_us == 0.5
    assert att.reads == {"hbrj.plan.prune": 1, "hbrj.plan_join": 1}
    assert att.host_us["hbrj.plan_join"] == [55, 0]
    assert att.per_query(att.busy_under(["hbrj.plan_join"])) == 0.01


def test_summary_is_per_query():
    att = spans.attribute(PROGRAM, MARKS, BENCH, OPS)
    got = spans.summary(att)
    assert got["queries"] == 2
    assert list(got["spans"]) == [p[0] for p in PROGRAM]
    pj = got["spans"]["hbrj.plan_join"]
    assert pj["count"] == 0.5 and pj["device_ms"] == 0.01
    assert pj["self_device_ms"] == 0.004 and pj["idle_ms"] == 0.0085
    assert pj["host_reads"] == 0.5 and pj["launches"] == 1.5
    assert pj["host_ms_p50"] == 0.0275
    assert got["unheld_share"] == 0.5 / 36.5
    assert got["idle_outside_ms"] == 111.5 / 2e3


def test_no_program_spans_reads_nothing():
    assert spans.attribute([], [], BENCH, OPS) is None
    assert spans.attribute(PROGRAM, MARKS, [], OPS) is None


def _profile(with_program: bool):
    """Three queries on the CPU, each a plan with a read and a join."""
    rf = torch.profiler.record_function
    x = torch.arange(1000)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with rf("query"):
                with rf("plan"):
                    if with_program:
                        with rf("hbrj.plan_join"):
                            (x * 2).sum()
                            with rf(spans.READ_MARK):
                                pass
                    else:
                        (x * 2).sum()
                with rf("full"):
                    if with_program:
                        with rf("hbrj.full"), rf("hbrj.probe"):
                            (x + 1).sum()
                    else:
                        (x + 1).sum()
    return prof


@pytest.mark.parametrize("with_program", [True, False])
def test_readers_find_the_stretch_s_profiler(with_program):
    """The metrics find the profiler of the run's stretch where the harness
    holds it, beside the readings; a program without spans gives them
    nothing to read."""
    from joinbench.run import Profiled, metric_reader

    profiled = Profiled(torch.device("cpu"))
    profiled.prof = _profile(with_program)
    st = tr.reduce(*tr.profiled_events(profiled.prof, torch.device("cpu")))
    readings = tr.Readings(config={}, traffic={}, card="cpu", plan_s=[1.0],
                           phase_ms={}, stretch=st)
    syncs = metric_reader("host_syncs_per_query")(readings)
    plan_ms = metric_reader("plan_device_ms")(readings)
    join_ms = metric_reader("build_probe_query_ms")(readings)
    assert metric_reader("partition_query_ms")(readings) is None
    if not with_program:
        assert syncs is plan_ms is join_ms is None
        return
    assert syncs == 1.0
    assert 0 < plan_ms and 0 < join_ms
    att = spans.of(readings)
    assert att is not None and att.queries == 3 and att.unheld_us == 0
    assert sum(att.idle.values()) + att.idle_outside_us == \
        pytest.approx(att.idle_us)


def test_readers_need_the_harness_s_profiler():
    """Readings built where no profiler is held give nothing to read,
    whatever profiler is alive elsewhere."""
    from joinbench.run import metric_reader

    prof = _profile(True)
    st = tr.reduce(*tr.profiled_events(prof, torch.device("cpu")))
    readings = tr.Readings(config={}, traffic={}, card="cpu", plan_s=[1.0],
                           phase_ms={}, stretch=st)
    assert metric_reader("host_syncs_per_query")(readings) is None
    assert metric_reader("plan_device_ms")(readings) is None
