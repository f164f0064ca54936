"""Roofline accounting: analytic bounds in place of hardware perf counters.

Counterpart of ``hwbloomradixjoin_tpu/utils/roofline.py``.  The reference
attributes cycles with perf_event / Intel PCM (src/perf_manager.c); here
every operator's bytes and integer operations are known from its sizes, so
its bound is the larger of bytes over the card's memory rate and operations
over its int32 rate, and attainment is that bound over the measured time.

One chip model, keyed by ``torch.cuda.get_device_name()``: the H100 SXM's
data-sheet figures, the ones ``chip_smoke.py`` bounds its kernels with
(3.35 TB/s HBM; 67e12 float32 operations a second count an FMA as two on
128 lanes an SM, int32 issues on 64 lanes an SM, one operation each:
67e12 / 4; a 50 MiB L2, the card's ``L2_cache_size``, which
``measurements/analysis.py`` classes build sides against).  A card with no model gets no bound, and so does a join
that ``join_costs`` does not describe (a tier outside MODELLED_TIERS, a
filter).  ``card_line`` names the card as results record it.
"""

from __future__ import annotations

import dataclasses
import subprocess


@dataclasses.dataclass(frozen=True)
class ChipModel:
    name: str
    hbm_bytes_per_s: float
    int32_ops_per_s: float
    hbm_gib: int
    l2_bytes: int


CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipModel("H100 SXM", 3.35e12, 67e12 / 4, 80,
                                       50 << 20),
}

# Integer operations a key of each operator (chip_smoke.py's OPS_PER_ELEM:
# the partition, two-pass partitioning's pass 2, the survivor compaction,
# the bitmap build and probe).
OPS_PER_KEY = {"partition": 14, "pass2": 20, "compact": 3, "build": 7,
               "probe": 9}

# The tiers join_costs describes: the bitmap radix join, count only, over
# 4-byte keys (cuda_key8b runs it over the low words).
MODELLED_TIERS = ("cuda_radix", "cuda_key8b")


def chip_model(device_name: str | None = None) -> ChipModel | None:
    """The model of the named card (default: CUDA device 0), or None."""
    if device_name is None:
        import torch
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    return CHIPS.get(device_name)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them for card 0 (e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def card_name(label: str) -> str:
    """The card's name in a card_line() label (the part before the power
    limit)."""
    return label.rsplit(", ", 1)[0]


@dataclasses.dataclass
class OpCost:
    """Analytic cost of one operator invocation."""

    name: str
    bytes_hbm: int           # HBM bytes read + written
    int_ops: int = 0         # int32 operations

    def bounds_s(self, chip: ChipModel) -> tuple[float, float]:
        """(bytes over the memory rate, operations over the int32 rate)."""
        return (self.bytes_hbm / chip.hbm_bytes_per_s,
                self.int_ops / chip.int32_ops_per_s)

    def bound_s(self, chip: ChipModel) -> float:
        return max(self.bounds_s(chip))

    def bound_by(self, chip: ChipModel) -> str:
        mem, ops = self.bounds_s(chip)
        return "bytes" if mem >= ops else "operations"

    def attainment(self, measured_s: float, chip: ChipModel) -> float:
        """The bound over the measured time (<= 1 up to timer noise)."""
        return self.bound_s(chip) / measured_s if measured_s > 0 else 0.0


def join_costs(n_r: int, n_s: int, span: int, passes: int = 1,
               s_live: int | None = None) -> dict:
    """Bytes and int32 operations of the bitmap radix join's phases on one
    card (MODELLED_TIERS), each phase reading its inputs once and writing
    its outputs once.

    span is R's key range (hi - lo + 1), one bitmap bit a key.  passes is
    S's partition passes (the two-pass plan partitions R once, at the
    probe's fan-out).  s_live is the S keys in R's range when the survivor
    compaction ran: it reads all of S and writes them, and the partition
    and the probe stream only them.  None means no compaction.
    """
    part = OPS_PER_KEY["partition"]
    bitmap = span // 8
    if s_live is None:
        s_live = n_s
        part_s = OpCost("partition_S", 2 * passes * n_s * 4,
                        n_s * (part + (passes - 1) * OPS_PER_KEY["pass2"]))
    else:
        part_s = OpCost("partition_S", (n_s + 3 * s_live) * 4,
                        n_s * OPS_PER_KEY["compact"] + s_live * part)
    return {
        "partition_R": OpCost("partition_R", 2 * n_r * 4, n_r * part),
        "build": OpCost("build", n_r * 4 + bitmap,
                        n_r * OPS_PER_KEY["build"]),
        "partition_S": part_s,
        "probe": OpCost("probe", s_live * 4 + bitmap,
                        s_live * OPS_PER_KEY["probe"]),
    }


def report(measured: dict[str, float], costs: dict[str, OpCost],
           chip: ChipModel | None) -> str:
    """Per operator: measured ms, achieved GB/s, the bound and what binds
    it, and attainment.  Without a chip model, a line that says so."""
    if chip is None:
        return "roofline: no chip model for this device; no bound printed"
    lines = [f"roofline ({chip.name}: {chip.hbm_bytes_per_s / 1e12:.2f} TB/s"
             f" HBM, {chip.int32_ops_per_s / 1e12:.2f}e12 int32 op/s, "
             f"{chip.hbm_gib} GiB):"]
    for name, secs in measured.items():
        c = costs.get(name)
        if c is None or secs <= 0:
            continue
        lines.append(
            f"  {name:14s} {secs * 1e3:9.3f} ms  "
            f"{c.bytes_hbm / secs / 1e9:8.1f} GB/s  bound "
            f"{c.bound_s(chip) * 1e3:8.3f} ms ({c.bound_by(chip)})  "
            f"attained {c.attainment(secs, chip) * 100:5.1f}%")
    return "\n".join(lines)
