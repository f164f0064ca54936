"""From a profiled stretch of whole queries and the plan's phases to the
numbers the per-layer metrics read.

The busy time is the union of the device operations' intervals, the
arithmetic of the port's ``profile.py``, taken over the host's span from
the first profiled query's start to the last one's end, so the host time
around the kernels counts as idle.  Idle time is named by the benchmark
span the host was in: ``plan`` (``plan_join``), ``full`` (issuing the
plan's join), ``readback`` (reading its result to the host) or ``loop``
(between them).  Phase times are CUDA-event means over repeated calls of
the plan's ``phase_fns()``.
"""

from __future__ import annotations

import dataclasses
import re
import time

import torch

SPANS = ("query", "plan", "full", "readback")
TOP = 10                   # entries a breakdown list keeps
PHASE_WARM, PHASE_CALLS = 2, 10


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    or parameters."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"<.*", "", base).split("::")[-1].split()[-1]


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a0, a1, merged) -> float:
    return sum(max(0.0, min(a1, b) - max(a0, a)) for a, b in merged)


@dataclasses.dataclass
class Stretch:
    """A profiled stretch of whole queries, in seconds."""

    queries: int
    window_s: float
    busy_s: float
    ops: dict                  # device operation name -> seconds
    idle: dict                 # host span name -> idle seconds in it


def reduce(ops, spans) -> Stretch:
    """ops: (name, start_us, end_us) of device operations; spans:
    (name, start_us, end_us) of the benchmark's host spans."""
    queries = [(a, b) for name, a, b in spans if name == "query"]
    w0 = min(a for a, _ in queries)
    w1 = max(b for _, b in queries)
    clipped = [(name, max(a, w0), min(b, w1)) for name, a, b in ops
               if b > w0 and a < w1]
    busy = merge((a, b) for _, a, b in clipped)
    by_name: dict = {}
    for name, a, b in clipped:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if edge < w1:
        gaps.append((edge, w1))
    idle = {"loop": sum(b - a for a, b in gaps) / 1e6}
    for name, a, b in spans:
        if name != "query":
            seconds = _overlap(a, b, gaps) / 1e6
            idle[name] = idle.get(name, 0.0) + seconds
            idle["loop"] -= seconds
    return Stretch(queries=len(queries), window_s=(w1 - w0) / 1e6,
                   busy_s=sum(b - a for a, b in busy) / 1e6, ops=by_name,
                   idle=idle)


def profiled_events(prof, device: torch.device):
    """(device operations, benchmark spans) of a finished profiler.

    On the card the operations are its CUDA activities (kernels, copies,
    sets); in a dry run on the CPU, the ATen operators stand in for them.
    """
    from torch.autograd import DeviceType

    ops, spans = [], []
    for ev in prof.events():
        interval = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.name in SPANS:
            if ev.device_type == DeviceType.CPU:
                spans.append(interval)
        elif device.type == "cuda":
            if ev.device_type == DeviceType.CUDA and \
                    not getattr(ev, "is_user_annotation", False):
                ops.append(interval)
        elif ev.name.startswith("aten::"):
            ops.append(interval)
    return ops, spans


def breakdown(stretch: Stretch) -> dict:
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                if v > 0][:TOP]
    return {"device_ops": top(stretch.ops), "idle_gaps": top(stretch.idle)}


def phase_ms(plan, device: torch.device) -> dict:
    """Mean milliseconds of each of the plan's phases: PHASE_WARM calls,
    then PHASE_CALLS back to back between two CUDA events (the host clock
    on the CPU), divided by the count."""
    out = {}
    for name, fn in plan.phase_fns().items():
        for _ in range(PHASE_WARM):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(PHASE_CALLS):
                fn()
            end.record()
            end.synchronize()
            out[name] = start.elapsed_time(end) / PHASE_CALLS
        else:
            t0 = time.perf_counter()
            for _ in range(PHASE_CALLS):
                fn()
            out[name] = (time.perf_counter() - t0) * 1e3 / PHASE_CALLS
    return out


@dataclasses.dataclass
class Readings:
    """What a traced run hands the per-layer metrics."""

    config: dict
    traffic: dict
    card: str
    plan_s: list               # host seconds of each query's plan_join
    phase_ms: dict             # phase name -> mean ms
    stretch: Stretch

    def phases_ms(self, names):
        """Sum of the named phases the plan has, or None if it has none."""
        seen = [self.phase_ms[n] for n in names if n in self.phase_ms]
        return sum(seen) if seen else None
