"""BENCHMARK.json and the files it names, and dry runs of the harness on
the CPU at tiny sizes."""

import json
import re
from pathlib import Path

import pytest
import torch

from joinbench import run

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
E2E = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["joinbench"]
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_cells_name_existing_configs_and_traffic():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in configs
        used.add(w["config"])
        assert (ROOT / "joinbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("joinbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []


def test_metrics():
    assert "setup_s" in E2E
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert (ROOT / "joinbench" / "metrics" / f"{m['name']}.py").is_file()
        assert callable(run.metric_reader(m["name"]))
        # every cell reports every end-to-end metric
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS)
                   for m in SPEC["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_prints_the_result_line(workload, trace, tiny, capsys):
    cell, config, traffic, per_layer = tiny(workload)
    out = run.execute(cell, config, traffic, per_layer, 2**31 + 3, 0.05,
                      trace, "cpu")
    run.emit(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert names == {m["name"] for m in per_layer}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the device's memory peak is not read on the CPU
        assert names == E2E - {"device_bytes_per_input_byte"}
    checks = captured.err.strip().splitlines()[-len(line["checks"]):]
    assert all(c.startswith("check ") for c in checks)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_foreign_modules(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "hwbloomradixjoin_tpu", types.ModuleType("y"))
    found = run.foreign_modules()
    assert "jax.numpy" in found and "hwbloomradixjoin_tpu" in found
    assert not any(n.startswith("hwbloomradixjoin_tpu_torch") for n in found)


def test_least_time_of_each_cell():
    from joinbench import costs
    want = {"brj_flagship.bloom": 4_608_000_008, "workload_b.pro":
            1_024_000_008, "brj_flagship.nofilter": 4_608_000_008,
            "workload_b.prho": 2_048_000_024}
    for workload, nbytes in want.items():
        _, config, traffic, _ = run.resolve(workload)
        assert costs.query_bytes(config, traffic) == nbytes
        assert costs.least_seconds(config, traffic) == nbytes / 3.35e12
