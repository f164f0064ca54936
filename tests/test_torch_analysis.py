"""PyTorch port: the sweep analysis, the figures and the rerun module.

The port's measurements/analysis.py against the repository's
measurements/analysis.py (over pandas) on the same rows, made from a seed;
its analyze and cross_run_table with pandas blocked; the device column the
sweep runner records; plot_basics' eight figures (and its error without
matplotlib); rerun's jobs against measurements/rerun-experiments.sh.
"""

import copy
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
from unittest import mock

import matplotlib
import numpy as np
import pandas as pd
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot  # noqa: E402,F401  (its import is the file's, not a case's)

from hwbloomradixjoin_tpu_torch.measurements import (analysis, plot_basics,
                                                     rerun, run)
from hwbloomradixjoin_tpu_torch.measurements.config import JoinConfig
from hwbloomradixjoin_tpu_torch.utils import roofline
from port_cpu import lean_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# a CLI run's stdout (tests/test_harness.py:44-55's sample)
SAMPLE = (
    "[INFO ] Creating relation R with size = 0.763 MiB, #tuples = 100000 : OK \n"
    "[INFO ] Creating relation S with size = 3.052 MiB, #tuples = 400000 : OK \n"
    "[INFO ] Running join algorithm PRO ...\n"
    "RUNTIME TOTAL, BUILD, PART (cycles): \n"
    "13777668 \t 1429536 \t 0 \n"
    "TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE: \n"
    "6562.0000 \t 100000 \t 16.4050 \n"
    "PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS: \n"
    "0.0000 \t 5881.0000\t 6562.0000 \n"
    "[INFO ] Results = 100000. DONE.\n")
VMEM = 128 << 20        # the JAX analysis' footprint size


def _jax_analysis():
    """measurements/analysis.py, imported by path (it edits sys.path at
    import, which is put back)."""
    spec = importlib.util.spec_from_file_location(
        "jax_measurements_analysis",
        os.path.join(REPO, "measurements", "analysis.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "path", list(sys.path)):
        spec.loader.exec_module(mod)
    return mod


JA = _jax_analysis()


def _rows(seed=7):
    """Sweep rows as measurements.run saves them: two algorithms x three
    |R| x two q, each without a filter and through three filters; one
    configuration lacks its no-filter row, one filtered row has no
    filtered count, and two rows tie on ns/tuple."""
    rng = np.random.default_rng(seed)
    rows = []
    for algo in ("PRO", "PRH"):
        for r_size, ratio in ((1000, 4), (4_000_000, 8), (20_000_000, 1)):
            for q in (0.01, 0.1):
                s_size = r_size * ratio
                for variant, k in (("no", 1), ("blocked", 1),
                                   ("blocked", 2), ("basic", 3)):
                    cfg = JoinConfig(algorithm=algo, r_size=r_size,
                                     s_size=s_size, selectivity=q,
                                     bloom_filter=variant,
                                     bloom_size=1 << int(rng.integers(16, 30)),
                                     bloom_hashes=k,
                                     radix_bits=int(rng.integers(4, 14)))
                    match = round(s_size * q)
                    filtered = None if variant == "no" else \
                        match + int((s_size - match) * rng.uniform(0, 0.3))
                    rows.append({
                        **cfg.__dict__, "s-size": s_size,
                        "filtered": filtered,
                        "filtered-pct": None if filtered is None
                        else filtered / s_size * 100,
                        "nsec-per-tuple": float(rng.uniform(0.01, 5.0)),
                        "results": match, "ratio": ratio, "q": q,
                        "device": CARD})
    rows = [r for r in rows if not (r["algorithm"] == "PRH" and r["r_size"]
                                    == 1000 and r["selectivity"] == 0.1
                                    and r["bloom_filter"] == "no")]
    rows[5]["filtered"] = rows[5]["filtered-pct"] = None
    rows[9]["nsec-per-tuple"] = rows[8]["nsec-per-tuple"] = 0.001
    return rows


def _same(got, want, rel=1e-12) -> bool:
    """got (the port's, None or NaN where missing) against want (pandas'
    NaN where missing)."""
    if want is None or (isinstance(want, float) and math.isnan(want)):
        return got is None or (isinstance(got, float) and math.isnan(got))
    if isinstance(want, (float, np.floating)):
        return got == pytest.approx(float(want), rel=rel, abs=0)
    return got == want


def test_add_fpr_is_the_jax_analysis_s():
    """fpr_emp and fpr_theo of every row as JAX's add_fpr gives them,
    NaN where the filtered count is missing."""
    rows = analysis.add_fpr(_rows())
    df = JA.add_fpr(pd.DataFrame(_rows()))
    assert math.isnan(rows[0]["fpr_emp"]) and math.isnan(rows[5]["fpr_theo"])
    for r, (_, w) in zip(rows, df.iterrows()):
        assert _same(r["fpr_emp"], w["fpr_emp"]), (r, w)
        assert _same(r["fpr_theo"], w["fpr_theo"]), (r, w)
    assert sum(not math.isnan(r["fpr_theo"]) for r in rows) > 30


def test_add_speedup_and_superiority_are_the_jax_analysis_s():
    """The speedup over the matching no-filter row (None where JAX has
    NaN: the configuration without one) and the bloom-superiority
    fraction."""
    rows = analysis.add_speedup(_rows())
    df = JA.add_speedup(pd.DataFrame(_rows()))
    missing = [r for r in rows if r["speedup"] is None]
    assert len(missing) == 3 and all(r["algorithm"] == "PRH"
                                     for r in missing)
    for r, (_, w) in zip(rows, df.iterrows()):
        assert _same(r["speedup"], w["speedup"]), (r, w)
    sup = analysis.brj_superiority(rows)
    assert 0 < sup < 1 and sup == JA.brj_superiority(df)
    assert math.isnan(analysis.brj_superiority([{"speedup": None}]))


@pytest.mark.parametrize("groups", [("selectivity",),
                                    ("selectivity", "ratio", "q"),
                                    ("ratio", "absent")])
def test_best_config_table_is_the_jax_analysis_s(groups):
    """Per group, in sorted order, the row of least ns/tuple (the first of
    a tie), with JAX's columns; None without a group column."""
    rows = analysis.add_speedup(_rows())
    df = JA.add_speedup(pd.DataFrame(_rows()))
    got = analysis.best_config_table(rows, group_cols=groups)
    want = JA.best_config_table(df, group_cols=groups)
    assert [list(g) for g in got] == [list(want.columns)] * len(got)
    assert len(got) == len(want) > 1
    for g, (_, w) in zip(got, want.iterrows()):
        assert all(_same(g[c], w[c]) for c in want.columns), (g, w)
    assert analysis.best_config_table(rows, group_cols=("absent",)) is None
    assert JA.best_config_table(df, group_cols=("absent",)) is None


@pytest.mark.parametrize("r_size", [1, 2_097_152, 2_097_153, 16_777_216,
                                    16_777_217, 1 << 30])
def test_footprint_class_at_128_mib_is_the_jax_analysis_s(r_size):
    """S, M, L against a 128 MiB cache, at and past each edge."""
    assert analysis.footprint_class(r_size, VMEM) == JA.footprint_class(r_size)


def test_footprint_breakdown_is_the_jax_analysis_s():
    """Per class (sorted): configurations, best, mean and worst ns/tuple."""
    rows = _rows()
    for r in rows:
        r["footprint"] = analysis.footprint_class(r["r_size"], VMEM)
    df = pd.DataFrame(_rows())
    df["footprint"] = df["r_size"].map(JA.footprint_class)
    got = analysis.footprint_breakdown(rows)
    want = JA.footprint_breakdown(df)
    assert [g["footprint"] for g in got] == list(want["footprint"]) \
        == ["L", "M", "S"]
    for g, (_, w) in zip(got, want.iterrows()):
        assert list(g) == list(want.columns)
        assert all(_same(g[c], w[c]) for c in want.columns), (g, w)
    assert analysis.footprint_breakdown(_rows()) is None


def test_analyze_and_cross_run_table_without_pandas(monkeypatch, tmp_path):
    """analyze writes <name>_analysis.md naming the rows' card, with the
    superiority fraction, the FPR table, the best config per (q, ratio,
    q) and footprint classes against the card's L2; cross_run_table gives
    JAX's rows (from pickles of the same rows) and each sweep's device.
    The port's side runs with pandas and matplotlib blocked."""
    rows = _rows()
    for r in rows[:6]:
        r["device"] = "cpu"
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    pd.DataFrame(rows).to_pickle(jax_dir / "mixed.pkl")
    pd.DataFrame(rows[6:]).to_pickle(jax_dir / "card.pkl")
    with mock.patch.object(JA, "DATA_DIR", str(jax_dir)):
        want = JA.cross_run_table()
    run.save_data(rows, "mixed", tmp_path)
    run.save_data(rows[6:], "card", tmp_path)
    run.save_data([{"case": "world", "devices": 8}], "world", tmp_path)
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    got = analysis.analyze(tmp_path / "card.jsonl")
    md = (tmp_path / "card_analysis.md").read_text()
    assert got["superiority"] == analysis.brj_superiority(got["rows"])
    assert f"bloom-superiority fraction ({CARD}): {got['superiority']:.3f}" \
        in md
    assert f"## best config per workload group ({CARD})" in md
    assert f"## FPR, empirical against theoretical ({CARD})" in md
    assert f"against {50 << 20} bytes of L2 ({CARD})" in md
    assert {r["footprint"] for r in got["rows"]} == {"S", "M", "L"}
    assert not (tmp_path / "card_fpr.png").exists()
    mixed = analysis.analyze(tmp_path / "mixed.jsonl")
    assert "footprint" not in mixed["rows"][0]
    assert f"on cpu; {CARD})" in (tmp_path / "mixed_analysis.md").read_text()
    assert analysis.analyze(tmp_path / "mixed.jsonl", l2_bytes=VMEM)[
        "rows"][0]["footprint"] == "S"

    table = analysis.cross_run_table(tmp_path)
    assert [t["sweep"] for t in table] == list(want["sweep"])
    for t, (_, w) in zip(table, want.iterrows()):
        assert all(_same(t[c], w[c]) for c in want.columns), (t, w)
    assert [t["device"] for t in table] == [CARD, CARD]
    assert f"| {CARD} |" in (tmp_path / "cross_run.md").read_text()


def test_fpr_plot_draws_by_k(tmp_path):
    """fpr_plot draws the rows' empirical FPRs by k beside the theory,
    titled with the rows' card; None without a filtered row."""
    rows = analysis.add_fpr(_rows())
    out = analysis.fpr_plot(rows, str(tmp_path / "fpr.png"))
    assert out and os.path.getsize(out) > 0
    assert analysis.fpr_plot(rows[:1], str(tmp_path / "none.png")) is None


def test_sweep_rows_record_their_device(monkeypatch):
    """run_one records cpu for the cpu backend and the card's name and
    power limit otherwise, as card_line reads them from nvidia-smi."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = SAMPLE if cmd[0] != "nvidia-smi" else CARD + "\n"
        return subprocess.CompletedProcess(cmd, 0, out, "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert run.run_one(JoinConfig(backend="cpu"))["device"] == "cpu"
    assert run.run_one(JoinConfig())["device"] == CARD
    assert [c[0] for c in calls[1:]] == [sys.executable, "nvidia-smi"]
    assert roofline.card_name(roofline.card_line()) == "NVIDIA H100 80GB HBM3"
    assert roofline.chip_model(roofline.card_name(CARD)).l2_bytes == 50 << 20


def _figure_rows(tmp_path):
    """Rows of every sweep a figure reads, as measurements.run saves them."""
    base = {"device": CARD}
    run.save_data([{**base, "algorithm": a, "radix-bits": b, "plan-bits":
                    b if b >= 0 else 9, "nsec-per-tuple": 0.05 + b / 100}
                   for a in ("PRO", "PRHO") for b in (-1, 12, 13, 14)],
                  "radix_bits", tmp_path)
    run.save_data([{**base, "local-join": e, "devices": d, "s_size": 4000,
                    "host-seconds": 1.0 / d, "scaling-efficiency": 0.9}
                   for e in ("pallas", "sortscan") for d in (1, 2, 4)],
                  "scaling", tmp_path)
    run.save_data([{**base, "bloom_filter": v, "bloom_hashes": k,
                    "nsec-per-tuple": 0.1 * k}
                   for v in ("no", "blocked", "basic") for k in (1, 2, 4)],
                  "bloom_filter_type", tmp_path)
    for name in ("algos", "algos_B"):
        run.save_data([{**base, "algorithm": a, "nsec-per-tuple": 0.05 * i}
                       for i, a in enumerate(("PRO", "PRH", "PRHO", "NPO"),
                                             1)], name, tmp_path)
    run.save_data([{**base, "passes": p, "nsec-per-tuple": 0.2 * p}
                   for p in (1, 2)], "passes", tmp_path)
    run.save_data([{**base, "bloom": v, "k": k, "s-exchanged-bytes": b,
                    "exchange-reduction": 64e6 / b}
                   for v, k, b in (("no", 0, 64e6), ("blocked", 1, 1.5e6),
                                   ("basic", 1, 1.6e6))],
                  "dist_bloom", tmp_path)


@pytest.mark.parametrize("name", sorted(plot_basics.PLOTS))
def test_plot_basics_draws_each_figure(monkeypatch, tmp_path, name):
    """Each of the eight figures is drawn from the port's rows under Agg,
    its title naming the rows' card (fpr: the theory and the reference
    CPU's points)."""
    _figure_rows(tmp_path)
    titles = []
    save = plot_basics._save

    def keep_title(fig, fname, figs):
        titles.append(fig.axes[0].get_title())
        return save(fig, fname, figs)

    monkeypatch.setattr(plot_basics, "_save", keep_title)
    path = plot_basics.PLOTS[name](tmp_path, tmp_path / "figs")
    assert path.exists() and path.stat().st_size > 0
    assert (CARD if name != "fpr" else "reference CPU") in titles[0]


def test_plot_basics_skips_a_missing_sweep_and_needs_matplotlib(
        monkeypatch, tmp_path, capsys):
    """A missing sweep gives one skip line and no figure; without
    matplotlib every figure and main raise, saying so."""
    assert plot_basics.plot_passes(tmp_path, tmp_path / "figs") is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("skip: ")
    assert not (tmp_path / "figs").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        plot_basics.plot_passes(tmp_path, tmp_path / "figs")
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        plot_basics.main(["all", "--rows", str(tmp_path)])


def _shell_jobs():
    """(sweep, sizes) of rerun-experiments.sh's chip branch, in order."""
    text = open(os.path.join(REPO, "measurements",
                             "rerun-experiments.sh")).read()
    chip = text.split("else", 1)[1].split("fi", 1)[0].replace("\\\n", " ")
    names = {"HBRJ_SWEEP_R": "r_size", "HBRJ_SWEEP_S": "s_size"}
    jobs = []
    for m in re.finditer(r"((?:HBRJ_SWEEP_\w+=\d+\s+)*)python "
                         r"measurements/run.py (\w+)", chip):
        sizes = {names[k]: int(v) for k, v in
                 re.findall(r"(HBRJ_SWEEP_\w+)=(\d+)", m.group(1))}
        jobs.append((m.group(2), sizes))
    return jobs


def test_rerun_card_jobs_are_the_shell_script_s():
    """rerun card runs the shell script's sweeps in its order at its
    sizes, and cpu its quick and scaling; every job names a sweep whose
    function takes its sizes."""
    import inspect
    assert rerun.JOBS["card"] == _shell_jobs()
    assert len(rerun.JOBS["card"]) == 9
    assert rerun.JOBS["cpu"] == [("quick", {}), ("scaling", {})]
    for name, sizes in rerun.JOBS["card"]:
        assert set(sizes) <= set(inspect.signature(run.SWEEPS[name])
                                 .parameters)


def test_rerun_runs_the_sweeps_then_the_analysis(monkeypatch, tmp_path,
                                                 capsys):
    """rerun cpu runs quick, then scaling, on the cpu backend, analyses
    every saved sweep, writes the cross-run table and, without
    matplotlib, names the rows and the command that draws them; an
    inexact row makes it exit 1.  rerun card raises without a card."""
    ran = []

    def fake(name, exact=True):
        def sweep(backend, out_dir, **sizes):
            ran.append((name, backend, sizes))
            return run.save_data([{"algorithm": "PRO", "r_size": 10,
                                   "nsec-per-tuple": 1.5, "results": 7,
                                   "exact": exact, "device": "cpu"}], name,
                                 out_dir)
        return sweep

    monkeypatch.setitem(run.SWEEPS, "quick", fake("quick"))
    monkeypatch.setitem(run.SWEEPS, "scaling", fake("scaling", False))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert rerun.main(["cpu", "--out", str(tmp_path)]) == 1
    assert ran == [("quick", "cpu", {}), ("scaling", "cpu", {})]
    for name in ("quick", "scaling"):
        assert (tmp_path / f"{name}_analysis.md").exists()
    assert json.loads(json.dumps(analysis.cross_run_table(tmp_path)))[0][
        "sweep"] == "quick"
    out = capsys.readouterr().out
    assert "INEXACT" in out and "figures not drawn" in out \
        and f"plot_basics all --rows {tmp_path}" in out
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rerun.main(["card", "--out", str(tmp_path)])
    assert len(ran) == 2


def test_rows_copy_is_unchanged_by_analysis():
    """The analysis adds columns to the rows it is given and changes no
    value the sweep saved."""
    rows = _rows()
    before = copy.deepcopy(rows)
    analysis.add_speedup(analysis.add_fpr(rows))
    for r, b in zip(rows, before):
        assert {k: r[k] for k in b} == b
