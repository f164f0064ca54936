"""Figure reproduction: the sweeps, their analysis, the figures.

Counterpart of the repository's ``measurements/rerun-experiments.sh``
(itself the reference's base_results/rerun-experiments.sh):

    python -m hwbloomradixjoin_tpu_torch.measurements.rerun cpu
    python -m hwbloomradixjoin_tpu_torch.measurements.rerun card --out DIR

``cpu`` runs the quick and scaling sweeps on the CPU backend (the plain
twins; no card needed).  ``card`` runs the shell script's sweeps on the
card, in its order and at its sizes: radix_bits, algos, algos_b, bloom,
passes, never_single_pass, params, scaling and dist_bloom, radix_bits,
algos, bloom and passes at 16M x 128M, scaling at 8M x 64M (the sizes are
arguments of the ``measurements.run`` sweep functions); without a card it
raises.  Then ``analysis.analyze`` runs over every saved sweep,
``analysis.cross_run_table`` over them all, and the figures
(``plot_basics``) are drawn where matplotlib imports; where it does not,
one line names the rows' directory and the command that draws them.
Exits non-zero if any row's count is inexact.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from hwbloomradixjoin_tpu_torch.measurements import (analysis, plot_basics,
                                                     run)

_16M_128M = {"r_size": 16_000_000, "s_size": 128_000_000}
# (sweep, sizes) in rerun-experiments.sh's order (:14-15, :21-34)
JOBS = {
    "cpu": [("quick", {}), ("scaling", {})],
    "card": [("radix_bits", _16M_128M), ("algos", _16M_128M),
             ("algos_b", {}), ("bloom", _16M_128M), ("passes", _16M_128M),
             ("never_single_pass", {}), ("params", {}),
             ("scaling", {"r_size": 8_000_000, "s_size": 64_000_000}),
             ("dist_bloom", {})],
}


def rerun(mode: str, out_dir=None) -> int:
    """Run mode's sweeps into out_dir (default run.OUT_DIR), then
    the analysis and the figures.  Returns the number of inexact rows."""
    from hwbloomradixjoin_tpu_torch.cli import device_of

    backend = "cpu" if mode == "cpu" else "auto"
    device_of(backend)                  # raises without a card
    out = Path(out_dir or run.OUT_DIR)
    bad = 0
    for name, sizes in JOBS[mode]:
        rows = run.SWEEPS[name](backend=backend, out_dir=out, **sizes)
        for r in rows:
            if r.get("exact") is False:
                print(f"INEXACT: {r}", flush=True)
                bad += 1
    for path in sorted(out.glob("*.jsonl")):
        analysis.analyze(path)
    analysis.cross_run_table(out)
    try:
        plot_basics.pyplot()
    except RuntimeError:
        print(f"figures not drawn (no matplotlib here); the rows are in "
              f"{out}: draw them where matplotlib imports with python -m "
              f"hwbloomradixjoin_tpu_torch.measurements.plot_basics all "
              f"--rows {out}", flush=True)
    else:
        plot_basics.main(["all", "--rows", str(out)])
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", default="card", choices=sorted(JOBS))
    p.add_argument("--out", default=None,
                   help=f"output directory (default {run.OUT_DIR})")
    a = p.parse_args(argv)
    return 1 if rerun(a.mode, a.out) else 0


if __name__ == "__main__":
    sys.exit(main())
