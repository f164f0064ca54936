"""Phase timing on the card and mchashjoins-compatible stdout formatting.

Counterpart of ``hwbloomradixjoin_tpu/utils/timing.py``.  Device work is timed
with CUDA events around launches on the current stream, after warming until
two consecutive single calls agree, so builds, allocator growth and cold
caches stay out of the numbers.  CPU tensors (the plain twins) are timed once
with the host clock after one warm call: a host time of a twin is no device
metric, and repeating it only lengthens CPU runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch


@dataclasses.dataclass
class JoinStats:
    total_usec: float = 0.0
    build_usec: float = 0.0
    part_usec: float = 0.0
    probe_usec: float = 0.0
    result: int = 0
    num_s_tuples: int = 0
    s_after_filter: int | None = None
    compile_usec: float = 0.0      # planning time, outside the timed join
    tier: str = ""                 # execution tier chosen by the planner
    # every timed phase in join order (usec), e.g. r_partition, build,
    # compact, s_partition, probe for the radix tier
    phases: dict = dataclasses.field(default_factory=dict)
    # the radix tiers' probe plan: (part_bits, shift, sl_rows, pad_cat)
    geometry: tuple | None = None

    @property
    def nsec_per_tuple(self) -> float:
        if not self.num_s_tuples:
            return 0.0
        return self.total_usec * 1000.0 / self.num_s_tuples


def _elapsed_usec(fn: Callable[[], object], device: torch.device,
                  calls: int) -> float:
    """Mean time of `calls` back-to-back calls of fn."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e6 / calls


_REPEATS = 3       # measurements; the best one is reported
_MAX_WARM = 20     # single warm-up calls at most
_STEADY = 0.05     # warm once two consecutive single calls agree this closely


def time_usec(fn: Callable[[], object], device: torch.device,
              calls: int = 1) -> float:
    """Best of _REPEATS measurements of `calls` back-to-back calls, per call.

    Warm-up: call fn singly until two consecutive times differ by at most
    _STEADY (relative), or _MAX_WARM calls.  On the CPU: one warm call, one
    measurement.
    """
    device = torch.device(device)
    if device.type != "cuda":
        fn()
        return _elapsed_usec(fn, device, calls)
    prev = None
    for _ in range(_MAX_WARM):
        t = _elapsed_usec(fn, device, 1)
        if prev is not None and abs(t - prev) <= _STEADY * prev:
            break
        prev = t
    return min(_elapsed_usec(fn, device, calls) for _ in range(_REPEATS))


def print_sync_stats(stats: JoinStats, phase_usec: dict[str, float]) -> None:
    """SYNCSTATS analogue: the per-phase device time table.

    The reference's --enable-syncstats dumps per-thread barrier-wait spans
    (parallel_radix_join_bloom.c:1710-1728); one device has no waits, so
    the diagnostic is the per-phase breakdown and the whole join's gain
    over the sum of its phases run alone (JAX utils/timing.py:61).
    """
    print(f"[SYNC] tier={stats.tier} fused_total={stats.total_usec:.1f}us")
    tot = 0.0
    for name, us in phase_usec.items():
        print(f"[SYNC]   phase {name:8s} {us:12.1f} us")
        tot += us
    if tot:
        print(f"[SYNC]   phase-sum {tot:12.1f} us "
              f"(fusion gain {tot - stats.total_usec:+.1f} us)")


def print_timing(stats: JoinStats) -> str:
    """Render the reference's timing block; returns the string (also printed)."""
    lines = []
    if stats.s_after_filter is not None:
        lines.append(f"S-tuples after filter: {stats.s_after_filter}")
    lines.append("RUNTIME TOTAL, BUILD, PART (cycles): ")
    lines.append(f"{int(stats.total_usec * 1000)} \t {int(stats.build_usec * 1000)}"
                 f" \t {int(stats.part_usec * 1000)} ")
    lines.append("TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE: ")
    lines.append(f"{stats.total_usec:.4f} \t {stats.result} \t {stats.nsec_per_tuple:.4f} ")
    lines.append("PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS: ")
    join_usec = max(stats.total_usec - stats.part_usec, 0.0)
    lines.append(f"{stats.part_usec:.4f} \t {stats.probe_usec:.4f}\t "
                 f"{join_usec:.4f} ")
    out = "\n".join(lines)
    print(out)
    return out
