"""Spans, the host-read counter and profiler capture.

Counterpart of ``hwbloomradixjoin_tpu/utils/profiling.py``.  The
reference's three observability tiers (SURVEY.md §5) map to: phase timers
-> ``utils/timing.py`` (CUDA events around each phase) and the spans
below; syncstats -> the per-kernel device timeline of a profiler trace;
perf counters -> ``utils/roofline.py``'s analytic bounds.

A span names one step of the planner or one phase of a plan's join,
``hbrj.<step>``.  It is live while a torch profiler runs: it then enters
``torch.profiler.record_function``, which puts the step on the profiler's
timeline beside the kernels it launched.  Otherwise ``span()`` returns one
shared no-op context and does nothing else.

``host_read`` is the one way the planner and the plans read a device value
back to the host; it counts every call, on any device, and marks the read
on a running profiler's timeline.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

READ_MARK = "hbrj.host_read"   # the profiler's zero-length mark of a read
HOST_READS = 0                 # host_read calls since import

_profiling = torch.autograd._profiler_enabled


class _Off:
    """The shared context of a span that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """The span of one step, ``hbrj.<step>``: a ``record_function`` while
    a profiler runs, else a no-op context."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


def host_read(x: torch.Tensor):
    """x on the host: a Python number for a 0-d tensor, else a CPU tensor.

    Counts the read (HOST_READS) and marks it on a running profiler's
    timeline."""
    global HOST_READS
    HOST_READS += 1
    if _profiling():
        with torch.profiler.record_function(READ_MARK):
            pass
    return x.item() if x.dim() == 0 else x.cpu()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture host and device activity around a region into a Chrome trace
    (``trace_<time>.json``, for chrome://tracing or Perfetto) in logdir,
    the program's spans on it."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))
