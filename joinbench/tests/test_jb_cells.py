"""The cells brj_flagship.bprho and pro16.q001 and the metric
ordered_prune_query_ms: how the harness resolves them, and what the
metric reads where there is nothing to read."""

import pytest
import torch

from joinbench import run, spans
from joinbench import trace as tr
from joinbench.tests.test_jb_spans import _profile

UNLISTED = ["plan_ms", "join_roofline_share", "device_idle_share"]
SPANNED = ["partition_ms", "build_probe_ms", "plan_device_ms",
           "host_syncs_per_query", "partition_query_ms",
           "build_probe_query_ms"]
FILTER = ["filter_build_ms", "filter_prune_ms", "filter_build_query_ms",
          "filter_prune_query_ms", "ordered_prune_query_ms"]


@pytest.mark.parametrize("workload,config,traffic,per_layer", [
    ("brj_flagship.bprho", "brj_flagship", "bloom_prho",
     UNLISTED + SPANNED + FILTER),
    ("pro16.q001", "pro16", "pro", UNLISTED + SPANNED),
])
def test_new_cells_resolve(workload, config, traffic, per_layer):
    cell, cfg, trf, metrics = run.resolve(workload)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (config, traffic, 1)
    assert cfg["reduced"] == [] and cfg["selectivity"] == 0.01
    assert cfg["key"] == cfg["payload"] == "int32"
    assert sorted(m["name"] for m in metrics) == sorted(per_layer)
    want = {"bloom_prho": ("PRHO", True, "sums", "cuda_prho"),
            "pro": ("PRO", False, "count", "cuda_radix")}[traffic]
    assert (trf["algorithm"], trf["filter"], trf["result"],
            trf["tier"]) == want
    assert trf["allow_dense"] is False


def test_ordered_prune_is_read_in_the_bprho_cell_alone():
    for workload in ("brj_flagship.bloom", "workload_b.pro",
                     "brj_flagship.nofilter", "workload_b.prho",
                     "pro16.q001"):
        names = [m["name"] for m in run.resolve(workload)[3]]
        assert "ordered_prune_query_ms" not in names


def _readings(prof):
    st = tr.reduce(*tr.profiled_events(prof, torch.device("cpu")))
    return tr.Readings(config={}, traffic={}, card="cpu", plan_s=[1.0],
                       phase_ms={}, stretch=st)


def test_ordered_prune_reads_none_without_a_trace():
    """No profiler held by the harness (an untraced run), or a program
    without the span (another path, or an older checkout): None."""
    read = run.metric_reader("ordered_prune_query_ms")
    assert read(_readings(_profile(True))) is None
    profiled = run.Profiled(torch.device("cpu"))
    profiled.prof = _profile(True)
    readings = _readings(profiled.prof)
    assert spans.of(readings) is not None
    assert read(readings) is None
