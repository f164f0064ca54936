"""The sweep figures, drawn from the port's sweep rows.

Counterpart of the repository's ``measurements/plot_basics.py`` (itself
the reference's measurements/plot_basics.py): the same eight figure
families, with its styling and palette, from the ``<sweep>.jsonl`` rows
``measurements.run`` saves:

    python -m hwbloomradixjoin_tpu_torch.measurements.plot_basics all
    python -m hwbloomradixjoin_tpu_torch.measurements.plot_basics bloom \\
        --rows DIR

    figure9     ns/tuple against radix bits      (radix_bits)
    figure11    PRO, PRH, PRHO, NPO               (algos)
    figure11_b  the same at workload B beside the reference's bars (algos_B)
    scaling     S-rows/s and efficiency against ranks (scaling)
    bloom       basic against blocked across k    (bloom_filter_type)
    fpr         theoretical FPR against k, the reference CPU's points
    passes      one against two partition passes  (passes)
    dist_bloom  S bytes the shuffle exchanges behind each filter (dist_bloom)

Every figure's title names the device its rows ran on (their ``device``
column).  Rows come from --rows (default ``run.OUT_DIR``), figures go to
<rows>/figures/.  A missing sweep gives one "skip" line.  It needs
matplotlib, and raises where matplotlib does not import; it does no
device work, so it can draw a card's rows on any machine.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from hwbloomradixjoin_tpu_torch.measurements import run
from hwbloomradixjoin_tpu_torch.measurements.analysis import devices

# fixed-order CVD-safe categorical palette (Okabe-Ito)
C = ["#0072B2", "#E69F00", "#009E73", "#CC79A7", "#56B4E9", "#D55E00"]
# the reference CPU's empirical FPR of the basic filter at m = 2^30, n =
# 128M (its bloom_filter_fpr.txt rows), by k
REFERENCE_FPR = {1: 0.11237, 2: 0.04500, 3: 0.02718, 6: 0.01779, 12: 0.03761}
# the reference's figure-11 bars at workload B (isengard, 8 threads, 14
# radix bits; base_results/figure11/*_B_14.txt), ns a tuple
REFERENCE_B = {"PRO": 9.85, "PRH": 12.73, "PRHO": 11.35}


def pyplot():
    """matplotlib.pyplot on the Agg backend, or a RuntimeError saying
    where the figures can be drawn."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "plot_basics needs matplotlib, which does not import here; copy "
            "the sweep rows to a machine that has it and run python -m "
            "hwbloomradixjoin_tpu_torch.measurements.plot_basics all --rows "
            "DIR") from e
    return plt


def _ax(title, xlabel, ylabel):
    fig, ax = pyplot().subplots(figsize=(6, 3.6), dpi=130)
    ax.set_title(title, fontsize=10)
    ax.set_xlabel(xlabel, fontsize=9)
    ax.set_ylabel(ylabel, fontsize=9)
    ax.grid(alpha=0.25, linewidth=0.5)
    ax.tick_params(labelsize=8)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    return fig, ax


def _save(fig, name, figs) -> Path:
    figs = Path(figs)
    figs.mkdir(parents=True, exist_ok=True)
    path = figs / f"{name}.png"
    fig.tight_layout()
    fig.savefig(path)
    pyplot().close(fig)
    print(f"wrote {path}", flush=True)
    return path


def _load(name, rows_dir):
    path = Path(rows_dir) / f"{name}.jsonl"
    if not path.exists():
        print(f"skip: {path} not found (run `python -m "
              f"hwbloomradixjoin_tpu_torch.measurements.run <sweep>` first)",
              flush=True)
        return None
    return run.load_rows(name, rows_dir)


def _title(what, rows):
    return f"{what}\n{devices(rows)}"


def plot_figure9(rows_dir, figs):
    """ns/tuple against the forced radix bits, one line an algorithm, the
    planner's own choice dashed (the reference's figure 9)."""
    pyplot()
    rows = _load("radix_bits", rows_dir)
    if rows is None:
        return None
    fig, ax = _ax(_title("radix-bits sweep (figure-9 analogue)", rows),
                  "partition fan-out bits", "ns / S-tuple")
    for i, algo in enumerate(dict.fromkeys(r["algorithm"] for r in rows)):
        d = sorted((r for r in rows if r["algorithm"] == algo
                    and r["radix-bits"] >= 0), key=lambda r: r["radix-bits"])
        ax.plot([r["radix-bits"] for r in d],
                [r["nsec-per-tuple"] for r in d], "-o", color=C[i],
                linewidth=2, markersize=5, label=algo)
        auto = [r for r in rows if r["algorithm"] == algo
                and r["radix-bits"] < 0]
        if auto:
            ax.axhline(auto[0]["nsec-per-tuple"], color=C[i], linewidth=1.2,
                       linestyle="--",
                       label=f"{algo} auto ({auto[0]['plan-bits']} bits)")
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, "figure9_radix_bits", figs)


def plot_scaling(rows_dir, figs):
    """S-rows/s by the host clock against ranks, one line a local join,
    each point labelled with its efficiency T(1) / (N T(N))."""
    pyplot()
    rows = _load("scaling", rows_dir)
    if rows is None:
        return None
    fig, ax = _ax(_title("distributed join scaling (gloo ranks)", rows),
                  "ranks", "S-rows / s (host clock)")
    for i, eng in enumerate(dict.fromkeys(r["local-join"] for r in rows)):
        d = sorted((r for r in rows if r["local-join"] == eng),
                   key=lambda r: r["devices"])
        xs = [r["devices"] for r in d]
        ys = [r["s_size"] / r["host-seconds"] for r in d]
        ax.plot(xs, ys, "-o", color=C[i], linewidth=2, markersize=5,
                label=eng)
        for x, y, r in zip(xs, ys, d):
            ax.annotate(f"{r['scaling-efficiency']:.0%}", (x, y),
                        textcoords="offset points", xytext=(0, 6),
                        fontsize=8, ha="center")
    ax.set_xscale("log", base=2)
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, "scaling", figs)


def plot_bloom(rows_dir, figs):
    """basic against blocked filter cost across k (the reference's
    best_bloom_filter_type)."""
    pyplot()
    rows = _load("bloom_filter_type", rows_dir)
    if rows is None:
        return None
    fig, ax = _ax(_title("bloom filter variant cost", rows),
                  "k (probes per key)", "ns / S-tuple")
    for i, variant in enumerate(("basic", "blocked")):   # fixed order
        d = sorted((r for r in rows if r["bloom_filter"] == variant),
                   key=lambda r: r["bloom_hashes"])
        ax.plot([r["bloom_hashes"] for r in d],
                [r["nsec-per-tuple"] for r in d], "-o", color=C[i],
                linewidth=2, markersize=5, label=variant)
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, "bloom_filter_type", figs)


def plot_fpr(rows_dir, figs):
    """Theoretical FPR against k at m = 2^30, n = 128M, beside the
    reference CPU's empirical points (the reference's calc_fpr curve)."""
    pyplot()
    from hwbloomradixjoin_tpu_torch.ops.bloom import theoretical_fpr

    ks = np.arange(1, 13)
    fig, ax = _ax("Bloom FPR vs k  (m=2$^{30}$, n=128M): theory and the "
                  "reference CPU", "k", "false-positive rate")
    ax.plot(ks, [theoretical_fpr(1 << 30, int(k), 128_000_000) for k in ks],
            "-", color=C[0], linewidth=2, label="theoretical")
    ax.plot(list(REFERENCE_FPR), list(REFERENCE_FPR.values()), "o",
            color=C[1], markersize=6,
            label="reference CPU, empirical (basic; bloom_filter_fpr.txt)")
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, "fpr_curve", figs)


def plot_figure11(rows_dir, figs):
    """PRO / PRH / PRHO / NPO on one workload (the reference's figure 11)."""
    pyplot()
    rows = _load("algos", rows_dir)
    if rows is None:
        return None
    by = {r["algorithm"]: r["nsec-per-tuple"] for r in rows}
    order = [a for a in ("PRO", "PRH", "PRHO", "NPO") if a in by]
    fig, ax = _ax(_title("join algorithm comparison (figure-11 analogue)",
                         rows), "", "ns / S-tuple")
    xs = np.arange(len(order))
    vals = [by[a] for a in order]
    ax.bar(xs, vals, color=C[:len(order)], width=0.62)
    ax.set_xticks(xs)
    ax.set_xticklabels(order, fontsize=9)
    for x, v in zip(xs, vals):
        ax.annotate(f"{v:.4f}", (x, v), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8)
    return _save(fig, "figure11_algos", figs)


def plot_figure11_b(rows_dir, figs):
    """Figure 11 at workload B (128M x 128M) beside the reference's bars;
    the reference has no NPO run there, so NPO shows the port's bar
    only."""
    pyplot()
    rows = _load("algos_B", rows_dir)
    if rows is None:
        return None
    by = {r["algorithm"]: r["nsec-per-tuple"] for r in rows}
    order = [a for a in ("PRO", "PRH", "PRHO", "NPO") if a in by]
    fig, ax = _ax(_title("workload B (128M$\\bowtie$128M): the port vs the "
                         "reference", rows), "", "ns / S-tuple")
    xs = np.arange(len(order))
    w = 0.38
    ax.bar(xs - w / 2, [REFERENCE_B.get(a, 0) for a in order], width=w,
           color=C[3], label="reference (isengard, 8 thr)")
    ax.bar(xs + w / 2, [by[a] for a in order], width=w, color=C[0],
           label="this port (one card)")
    ax.set_xticks(xs)
    ax.set_xticklabels(order, fontsize=9)
    for x, a in zip(xs + w / 2, order):
        ax.annotate(f"{by[a]:.4f}", (x, by[a]), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8)
    ax.legend(fontsize=8)
    return _save(fig, "figure11_algos_B", figs)


def plot_passes(rows_dir, figs):
    """One against two partition passes (the reference's
    never_single_pass axis)."""
    pyplot()
    rows = _load("passes", rows_dir)
    if rows is None:
        return None
    d = sorted(rows, key=lambda r: r["passes"])
    fig, ax = _ax(_title("partitioning passes", rows), "passes",
                  "ns / S-tuple")
    ax.bar([str(r["passes"]) for r in d], [r["nsec-per-tuple"] for r in d],
           color=[C[0], C[1]][:len(d)], width=0.5)
    return _save(fig, "passes", figs)


def plot_dist_bloom(rows_dir, figs):
    """The S bytes the distributed join's shuffle exchanges behind each
    filter, with the reduction over no filter."""
    pyplot()
    rows = _load("dist_bloom", rows_dir)
    if rows is None:
        return None
    labels = ["no filter" if r["bloom"] == "no" else f"{r['bloom']} k={r['k']}"
              for r in rows]
    mib = [r["s-exchanged-bytes"] / 2**20 for r in rows]
    fig, ax = _ax(_title("distributed: S bytes the shuffle exchanges", rows),
                  "", "MiB shuffled")
    xs = np.arange(len(rows))
    ax.bar(xs, mib, color=[C[0] if r["bloom"] == "no" else C[2]
                           for r in rows], width=0.62)
    ax.set_xticks(xs)
    ax.set_xticklabels(labels, fontsize=8)
    for x, v, r in zip(xs, mib, rows):
        red = r["exchange-reduction"]
        ax.annotate(f"{red:.1f}x" if red > 1.01 else "", (x, v),
                    textcoords="offset points", xytext=(0, 3), ha="center",
                    fontsize=8)
    return _save(fig, "dist_bloom", figs)


PLOTS = {"figure9": plot_figure9, "scaling": plot_scaling,
         "bloom": plot_bloom, "fpr": plot_fpr,
         "figure11": plot_figure11, "figure11_b": plot_figure11_b,
         "passes": plot_passes, "dist_bloom": plot_dist_bloom}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", nargs="?", default="all",
                   choices=["all", *PLOTS])
    p.add_argument("--rows", default=None,
                   help=f"sweep rows directory (default {run.OUT_DIR})")
    a = p.parse_args(argv)
    pyplot()
    rows = Path(a.rows or run.OUT_DIR)
    for name in PLOTS if a.which == "all" else [a.which]:
        PLOTS[name](rows, rows / "figures")
    return 0


if __name__ == "__main__":
    sys.exit(main())
