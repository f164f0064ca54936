"""Derived metrics over the port's sweep rows, with no pandas.

Counterpart of the repository's ``measurements/analysis.py`` (itself the
reference's measurements/analysis.py): the same functions and results over
the rows ``measurements.run`` saves (``<sweep>.jsonl``, a list of dicts,
one a configuration) instead of pickled DataFrames:

    python -m hwbloomradixjoin_tpu_torch.measurements.analysis
    python -m hwbloomradixjoin_tpu_torch.measurements.analysis bloom_filter_type
    python -m hwbloomradixjoin_tpu_torch.measurements.analysis cross --out DIR

With no name it analyses every sweep in the output directory (default
``run.OUT_DIR``), writing ``<sweep>_analysis.md`` beside each (and
``<sweep>_fpr.png`` where matplotlib imports); ``cross`` writes
``cross_run.md``, one row a sweep.  Every table names the device its rows
ran on (the ``device`` column: the card's name and power limit, or cpu).

Footprint classes: R's working set against the card's L2
(``utils/roofline.ChipModel.l2_bytes``, read by the rows' card name), where
the reference classes against cache levels; rows that ran on the CPU have
no card, so their classes need ``--l2-bytes``.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

from hwbloomradixjoin_tpu_torch.measurements import run

NO_DEVICE = "device not recorded"


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _columns(rows: list[dict]) -> set:
    """Every column some row holds (a DataFrame's columns)."""
    return {k for r in rows for k in r}


def add_fpr(rows: list[dict]) -> list[dict]:
    """Empirical and theoretical FPR of each row (the reference's add_fpr).

    fpr_theo = (1 - (1 - 1/m)^(k n))^k with n = |R|; fpr_emp from the
    filtered count: survivors = true matches + FP x negatives, true matches
    = round(|S| q).  Both NaN where the row has no filtered count."""
    for r in rows:
        if r.get("filtered") is None:
            r["fpr_emp"] = r["fpr_theo"] = math.nan
            continue
        true_matches = float(round(r["s-size"] * float(r["selectivity"])))
        negatives = r["s-size"] - true_matches
        r["fpr_emp"] = (r["filtered"] - true_matches) / negatives
        m, k = float(r["bloom_size"]), r["bloom_hashes"]
        r["fpr_theo"] = (1 - (1 - 1 / m) ** (k * r["r_size"])) ** k
    return rows


def _speedup_key(r: dict) -> tuple:
    return r["algorithm"], r["r_size"], r["s_size"], r["selectivity"]


def add_speedup(rows: list[dict], baseline_col: str = "nsec-per-tuple"):
    """Speedup of each row over its configuration without a filter: the
    first row of equal (algorithm, r_size, s_size, selectivity) whose
    bloom_filter is "no".  None where no such row exists."""
    base = {}
    for r in rows:
        if r.get("bloom_filter") == "no":
            base.setdefault(_speedup_key(r), r[baseline_col])
    for r in rows:
        b = base.get(_speedup_key(r))
        r["speedup"] = None if b is None else \
            (math.inf if r[baseline_col] == 0 else b / r[baseline_col])
    return rows


def footprint_class(r_size: int, cache_bytes: int,
                    tuple_bytes: int = 8) -> str:
    """S, M or L: R's working set within an eighth of the cache, within
    it, or past it (the reference's get_required_space classes)."""
    ws = r_size * tuple_bytes
    if ws <= cache_bytes // 8:
        return "S"
    if ws <= cache_bytes:
        return "M"
    return "L"


def brj_superiority(rows: list[dict]) -> float:
    """The share of rows with a speedup whose speedup is above 1 (the
    reference's brj_superiority), or NaN where no row has one."""
    d = [r["speedup"] for r in rows if not _missing(r.get("speedup"))]
    if not d:
        return math.nan
    return sum(s > 1.0 for s in d) / len(d)


def best_config_table(rows: list[dict], group_cols=("selectivity",),
                      metric: str = "nsec-per-tuple"):
    """The best configuration of each workload group: per group of the
    group columns the rows hold (groups in sorted order; a row missing a
    group value is in none), the row of least metric, the first on a tie.
    None where no group column or no row with the metric exists."""
    seen = _columns(rows)
    d = [r for r in rows if not _missing(r.get(metric))]
    cols = [c for c in group_cols if c in seen]
    if not cols or not d:
        return None
    best = {}
    for r in d:
        key = tuple(r.get(c) for c in cols)
        if any(_missing(v) for v in key):
            continue
        if key not in best or r[metric] < best[key][metric]:
            best[key] = r
    keep = [c for c in (*cols, "algorithm", "bloom_filter", "bloom_hashes",
                        "radix_bits", "passes", metric, "filtered-pct",
                        "speedup") if c in seen]
    return [{c: best[key].get(c) for c in keep} for key in sorted(best)]


def footprint_breakdown(rows: list[dict], metric: str = "nsec-per-tuple"):
    """Per footprint class (sorted): configurations and the best, mean and
    worst metric.  None where the rows have no footprint or metric."""
    seen = _columns(rows)
    if "footprint" not in seen or metric not in seen:
        return None
    groups = {}
    for r in rows:
        if not _missing(r.get(metric)) and not _missing(r.get("footprint")):
            groups.setdefault(r["footprint"], []).append(r[metric])
    return [{"footprint": fp, "configs": len(v), f"best {metric}": min(v),
             f"mean {metric}": sum(v) / len(v), f"worst {metric}": max(v)}
            for fp, v in sorted(groups.items())]


def devices(rows: list[dict]) -> str:
    """The devices the rows ran on, as their device column names them."""
    got = list(dict.fromkeys(r.get("device") or NO_DEVICE for r in rows))
    return "; ".join(got) if got else NO_DEVICE


def card_l2_bytes(rows: list[dict]):
    """The L2 of the one card the rows ran on, from its chip model; None
    where they ran on the CPU, on several devices or on a card with no
    model."""
    from hwbloomradixjoin_tpu_torch.utils import roofline

    labels = {r.get("device") for r in rows}
    if len(labels) != 1 or None in labels or "cpu" in labels:
        return None
    chip = roofline.chip_model(roofline.card_name(labels.pop()))
    return None if chip is None else chip.l2_bytes


def fpr_plot(rows: list[dict], out_png: str):
    """Empirical against theoretical FPR by k from the sweep rows (the
    reference's bloom_filter_fpr plot family), titled with the rows'
    device.  Returns the path, or None where no row has both FPRs or
    matplotlib does not import (with a line saying so)."""
    d = [r for r in rows if not _missing(r.get("fpr_emp"))
         and not _missing(r.get("fpr_theo"))]
    if not d:
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"fpr plot not drawn: no matplotlib ({out_png})", flush=True)
        return None
    fig, ax = plt.subplots(figsize=(5, 3.4))
    for variant in dict.fromkeys(r["bloom_filter"] for r in d):
        dd = sorted((r for r in d if r["bloom_filter"] == variant),
                    key=lambda r: r["bloom_hashes"])
        ax.plot([r["bloom_hashes"] for r in dd],
                [r["fpr_emp"] * 100 for r in dd], "o-",
                label=f"{variant} (empirical)")
    theo = {}
    for r in sorted(d, key=lambda r: r["bloom_hashes"]):
        theo.setdefault(r["bloom_hashes"], r["fpr_theo"])
    ax.plot(list(theo), [v * 100 for v in theo.values()], "k--",
            label="theoretical")
    ax.set_title(devices(d), fontsize=8)
    ax.set_xlabel("k (hash functions)")
    ax.set_ylabel("FPR [%]")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    print(f"wrote {out_png}")
    return out_png


TABLE_COLS = ("algorithm", "r_size", "s_size", "selectivity", "bloom_filter",
              "bloom_hashes", "nsec-per-tuple", "filtered-pct", "fpr_emp",
              "fpr_theo", "speedup", "footprint", "results")
FPR_COLS = ("bloom_filter", "bloom_size", "bloom_hashes", "r_size",
            "s_size", "selectivity", "filtered", "fpr_emp", "fpr_theo")


def analyze(path, l2_bytes: int | None = None) -> dict:
    """Analyse one sweep's rows (<name>.jsonl): FPRs, speedups and the
    bloom-superiority fraction where a filtered row exists, the footprint
    class of each row (against l2_bytes, default the rows' card's L2), the
    best configuration per (selectivity, ratio, q) group and the footprint
    breakdown; writes <name>_analysis.md (and <name>_fpr.png).  Returns
    the rows, the fraction (None without filtered rows), the tables and
    the markdown's path."""
    path = Path(path)
    rows = run.load_rows(path.stem, path.parent)
    dev = devices(rows)
    sup = None
    if any("bloom_size" in r for r in rows) and \
            any(r.get("bloom_filter", "no") != "no" for r in rows):
        add_fpr(rows)
        add_speedup(rows)
        sup = brj_superiority(rows)
    if l2_bytes is None:
        l2_bytes = card_l2_bytes(rows)
    if l2_bytes is not None:
        for r in rows:
            if "r_size" in r:
                r["footprint"] = footprint_class(r["r_size"], l2_bytes)
    seen = _columns(rows)
    parts = [f"# {path.stem} ({len(rows)} rows on {dev})\n",
             run.markdown(rows, [c for c in TABLE_COLS if c in seen])]
    if sup is not None:
        parts.append(f"\nbloom-superiority fraction ({dev}): {sup:.3f}\n")
        fpr = [r for r in rows if not _missing(r.get("fpr_emp"))]
        parts += [f"\n## FPR, empirical against theoretical ({dev})\n\n",
                  run.markdown(fpr, [c for c in FPR_COLS if c in seen])]
    bc = best_config_table(rows, group_cols=("selectivity", "ratio", "q"))
    if bc:
        parts += [f"\n## best config per workload group ({dev})\n\n",
                  run.markdown(bc)]
    fb = footprint_breakdown(rows)
    if fb is not None and len(fb) > 1:
        parts += [f"\n## footprint classes against {l2_bytes} bytes of L2 "
                  f"({dev})\n\n", run.markdown(fb)]
    elif l2_bytes is None:
        parts.append(f"\nfootprint classes: no card L2 for rows on {dev} "
                     "(pass --l2-bytes)\n")
    out = path.with_name(f"{path.stem}_analysis.md")
    out.write_text("".join(parts))
    if sup is not None:
        fpr_plot(rows, str(path.with_name(f"{path.stem}_fpr.png")))
    print(f"{path.stem}: {len(rows)} rows on {dev}; bloom-superiority "
          f"fraction {'none (no filtered row)' if sup is None else sup}; "
          f"wrote {out}", flush=True)
    return {"rows": rows, "superiority": sup, "best": bc, "footprint": fb,
            "path": out}


def cross_run_table(out_dir=None) -> list[dict]:
    """One row a saved sweep with a ns/tuple column (the reference's
    cross-run summary): its configurations, the best ns/tuple, the best
    configuration, its count and its device.  Writes cross_run.md in the
    sweep output directory and prints it."""
    out = Path(out_dir or run.OUT_DIR)
    table = []
    for path in sorted(out.glob("*.jsonl")):
        rows = run.load_rows(path.stem, out)
        timed = [r for r in rows if not _missing(r.get("nsec-per-tuple"))]
        if not timed:
            continue
        best = min(timed, key=lambda r: r["nsec-per-tuple"])
        table.append({
            "sweep": path.stem,
            "configs": len(rows),
            "best ns/tuple": round(float(best["nsec-per-tuple"]), 3),
            "best config": " ".join(
                f"{k}={best[k]}" for k in ("algorithm", "bloom_filter",
                                           "bloom_hashes", "radix_bits",
                                           "devices", "passes")
                if k in best and best[k] not in (None, "no", 0, 1)),
            "results": int(best["results"]) if best.get("results") else None,
            "device": best.get("device") or NO_DEVICE,
        })
    md = run.markdown(table, ["sweep", "configs", "best ns/tuple",
                              "best config", "results", "device"])
    path = out / "cross_run.md"
    path.write_text(md)
    print(md, end="")
    print(f"wrote {path}", flush=True)
    return table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sweeps", nargs="*",
                   help="sweep names or .jsonl paths, or 'cross' (default: "
                        "every sweep in the output directory)")
    p.add_argument("--out", default=None,
                   help=f"sweep output directory (default {run.OUT_DIR})")
    p.add_argument("--l2-bytes", type=int, default=None,
                   help="the cache the footprint classes use (default: the "
                        "rows' card's L2)")
    a = p.parse_args(argv)
    out = Path(a.out or run.OUT_DIR)
    if a.sweeps == ["cross"]:
        cross_run_table(out)
        return 0
    paths = [Path(s) if s.endswith(".jsonl") else out / f"{s}.jsonl"
             for s in a.sweeps] or sorted(out.glob("*.jsonl"))
    for path in paths:
        analyze(path, a.l2_bytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
