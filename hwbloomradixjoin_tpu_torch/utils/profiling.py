"""Profiler capture: torch.profiler traces in place of the reference's
rdtsc and perf-counter hooks.

Counterpart of ``hwbloomradixjoin_tpu/utils/profiling.py``.  The
reference's three observability tiers (SURVEY.md §5) map to: phase timers
-> ``utils/timing.py`` (CUDA events around each phase); syncstats -> the
per-kernel device timeline of this module's trace; perf counters ->
``utils/roofline.py``'s analytic bounds.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture host and device activity around a region into a Chrome trace
    (``trace_<time>.json``, for chrome://tracing or Perfetto) in logdir."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named trace region (a span on the host timeline, over its kernels)."""
    return torch.profiler.record_function(name)
