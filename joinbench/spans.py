"""The program's own spans in the profiled stretch: what each step of
planning and of the join costs on the device, and what the host was doing
while the device sat idle.

The port names its steps ``hbrj.<step>`` (``plan_join``, ``full``, the
planning steps ``plan.*`` and the phases its plans' ``phase_fns()`` name)
and marks every read of a device value to the host ``hbrj.host_read``.
While a profiler runs, each is a ``record_function`` on the profiler's
timeline, on the same clock as the device operations.  From a finished
profiler:

- the program spans nest by their host intervals into one tree;
- each device operation goes to the innermost program span open at its
  launch (the CUDA runtime call that launched it; on the CPU the ATen
  operation stands in for both);
- each idle gap of the busy union (``trace.reduce``'s arithmetic) is cut
  at span edges, and each piece goes to the innermost program span open on
  the host, or to none.

The harness hands a metric only ``trace.Readings``, which does not carry
the profiler's events; ``_stretch_profiler`` takes them from the harness's
own frame (see there).  A program without spans (an older checkout) leaves
the trace without ``hbrj.*`` events: every reading here is then None.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import statistics
import sys

from joinbench.run import p95
from joinbench.trace import SPANS, merge

PREFIX = "hbrj."
READ_MARK = "hbrj.host_read"


@dataclasses.dataclass
class Node:
    name: str
    start: float               # microseconds, the profiler's clock
    end: float
    parent: int | None = None


@dataclasses.dataclass
class Attribution:
    """A stretch's program spans and what they hold, in microseconds."""

    queries: int
    nodes: list                # Node, parents before children
    busy_us: float
    idle_us: float
    under: dict                # span name -> union of the ops under it
    self_busy: dict            # span name -> busy us of the ops it launched
    ops: dict                  # span name -> device operations under it
    idle: dict                 # span name -> idle us while it was innermost
    idle_outside_us: float     # idle us under no program span
    reads: dict                # span name -> host reads charged to it
    host_us: dict              # span name -> [host us of each query]
    unheld_us: float           # busy us under no program span nor readback

    def per_query(self, us: float) -> float:
        """Milliseconds a query of `us` microseconds of the stretch."""
        return us / self.queries / 1e3

    def busy_under(self, names) -> float | None:
        """Busy us of the operations under any span of `names`, or None
        where no such span launched one."""
        seen = [iv for n in names for iv in self.under.get(n, ())]
        return _length(seen) if seen else None


def _length(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def _innermost_map(nodes):
    """(bounds, owner): owner[i] is the index of the innermost node over
    [bounds[i], bounds[i + 1]), or None."""
    bounds = sorted({t for n in nodes for t in (n.start, n.end)})
    owner = [None] * max(len(bounds) - 1, 0)
    for i, n in enumerate(nodes):          # parents first: children paint over
        a = bisect.bisect_left(bounds, n.start)
        b = bisect.bisect_left(bounds, n.end)
        owner[a:b] = [i] * (b - a)
    return bounds, owner


def _owner_at(bounds, owner, t):
    i = bisect.bisect_right(bounds, t) - 1
    return owner[i] if 0 <= i < len(owner) else None


def _tree(spans):
    """Nodes of (name, start, end) host spans, nested by containment."""
    nodes, stack = [], []
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and not (nodes[stack[-1]].start <= a
                             and b <= nodes[stack[-1]].end):
            stack.pop()
        nodes.append(Node(name, a, b, stack[-1] if stack else None))
        stack.append(len(nodes) - 1)
    return nodes


def attribute(program, marks, bench, ops) -> Attribution | None:
    """program: (name, start, end) of the program's spans; marks: times of
    its host reads; bench: (name, start, end) of the benchmark's spans;
    ops: (start, end, launch) of device operations.  None without a query
    span or a program span."""
    queries = sorted((a, b) for name, a, b in bench if name == "query")
    if not queries or not program:
        return None
    w0, w1 = queries[0][0], max(b for _, b in queries)
    nodes = _tree(s for s in program if s[2] > w0 and s[1] < w1)
    bounds, owner = _innermost_map(nodes)

    def chain(i):
        names = []
        while i is not None:
            if nodes[i].name not in names:
                names.append(nodes[i].name)
            i = nodes[i].parent
        return names

    readback = merge((a, b) for name, a, b in bench if name == "readback")
    under, mine, count, unheld = {}, {}, {}, []
    clipped = []
    for a, b, launch in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        i = _owner_at(bounds, owner, launch)
        if i is None:
            if not any(x <= launch <= y for x, y in readback):
                unheld.append((a, b))
            continue
        mine.setdefault(nodes[i].name, []).append((a, b))
        for name in chain(i):
            under.setdefault(name, []).append((a, b))
            count[name] = count.get(name, 0) + 1

    busy = merge(clipped)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < w1:
        gaps.append((edge, w1))
    idle, outside = {}, 0.0
    for a, b in gaps:
        i = max(bisect.bisect_right(bounds, a) - 1, -1)
        t = a
        while t < b:
            nxt = bounds[i + 1] if i + 1 < len(bounds) else b
            piece = min(b, nxt) - t
            j = owner[i] if 0 <= i < len(owner) else None
            if j is None:
                outside += piece
            else:
                idle[nodes[j].name] = idle.get(nodes[j].name, 0.0) + piece
            t, i = min(b, nxt), i + 1

    reads = {}
    for t in marks:
        if w0 <= t <= w1:
            i = _owner_at(bounds, owner, t)
            if i is not None:
                reads[nodes[i].name] = reads.get(nodes[i].name, 0) + 1
    host = {}
    for q, (a, b) in enumerate(queries):
        for n in nodes:
            if a <= n.start < b:
                host.setdefault(n.name, [0.0] * len(queries))[q] += \
                    n.end - n.start
    return Attribution(
        queries=len(queries), nodes=nodes, busy_us=_length(clipped),
        idle_us=sum(b - a for a, b in gaps),
        under={k: merge(v) for k, v in under.items()},
        self_busy={k: _length(v) for k, v in mine.items()}, ops=count,
        idle=idle, idle_outside_us=outside, reads=reads, host_us=host,
        unheld_us=_length(unheld))


def profiled(prof, on_card: bool):
    """(program spans, read marks, benchmark spans, device operations) of
    a finished profiler; an operation is (start, end, launch time)."""
    from torch.autograd import DeviceType

    program, marks, bench, ops, runtime = [], [], [], [], {}
    events = list(prof.events())
    for ev in events:
        if ev.device_type != DeviceType.CPU:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if ev.name == READ_MARK:
            marks.append(a)
        elif ev.name.startswith(PREFIX):
            program.append((ev.name, a, b))
        elif ev.name in SPANS:
            bench.append((ev.name, a, b))
        elif on_card and ev.name.startswith("cu"):
            runtime[ev.id] = a             # the runtime call's correlation
        elif not on_card and ev.name.startswith("aten::"):
            ops.append((a, b, a))
    if on_card:
        frontend = {ev.id: ev.time_range.start for ev in events
                    if ev.device_type == DeviceType.CPU
                    and not ev.name.startswith("cu")}
        for ev in events:
            if ev.device_type == DeviceType.CUDA and \
                    not getattr(ev, "is_user_annotation", False):
                launch = runtime.get(ev.id)
                if launch is None:
                    launch = frontend.get(getattr(ev, "linked_correlation_id",
                                                  0), ev.time_range.start)
                ops.append((ev.time_range.start, ev.time_range.end, launch))
    return program, marks, bench, ops


def _stretch_profiler(readings):
    """The torch profiler of the run that built `readings`, or None.

    A stopgap: ``run.execute`` builds the readings beside the ``Profiled``
    that holds its profiler, so the caller's frame that holds this very
    ``readings`` object holds that profiler as ``profiled.prof``.  The
    ``benchmark`` PR that puts the profiler's events on ``trace.Readings``
    (ROADMAP.md, item 15) removes this function, and ``of`` reads them
    there.
    """
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("readings") is readings and "profiled" in local:
            return getattr(local["profiled"], "prof", None)
        frame = frame.f_back
    return None


_CACHE: dict = {}


def of(readings) -> Attribution | None:
    """The attribution of the traced run's stretch (computed once a run,
    when its line is logged), or None where the trace holds no program
    span."""
    key = id(readings.stretch)
    if key not in _CACHE:
        _CACHE.clear()
        prof = _stretch_profiler(readings)
        on_card = readings.card != "cpu"
        got = None if prof is None else attribute(*profiled(prof, on_card))
        _CACHE[key] = (readings.stretch, got)
        if got is not None:
            print("joinbench: spans " + json.dumps(summary(got)),
                  file=sys.stderr, flush=True)
    return _CACHE[key][1]


def ms_under(readings, names) -> float | None:
    """Device ms a query of the operations under any span of `names`, or
    None where the trace holds none."""
    att = of(readings)
    us = None if att is None else att.busy_under(names)
    return None if us is None else att.per_query(us)


def summary(att: Attribution) -> dict:
    """span name -> its numbers a query, and the stretch's totals."""
    names = sorted(att.host_us, key=lambda n: min(
        i for i, node in enumerate(att.nodes) if node.name == n))
    out = {}
    for n in names:
        host = [us / 1e3 for us in att.host_us[n]]
        out[n] = {"count": sum(1 for x in att.nodes if x.name == n)
                  / att.queries,
                  "host_ms_p50": statistics.median(host),
                  "host_ms_p95": p95(host),
                  "device_ms": att.per_query(att.busy_under([n]) or 0.0),
                  "self_device_ms": att.per_query(att.self_busy.get(n, 0.0)),
                  "idle_ms": att.per_query(att.idle.get(n, 0.0)),
                  "host_reads": att.reads.get(n, 0) / att.queries,
                  "launches": att.ops.get(n, 0) / att.queries}
    return {"queries": att.queries, "spans": out,
            "busy_ms": att.per_query(att.busy_us),
            "idle_ms": att.per_query(att.idle_us),
            "idle_outside_ms": att.per_query(att.idle_outside_us),
            "unheld_share": att.unheld_us / att.busy_us if att.busy_us
            else 0.0}
