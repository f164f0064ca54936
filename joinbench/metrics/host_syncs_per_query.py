"""host_syncs_per_query: the program's host reads a query, the
``hbrj.host_read`` marks that its counter ``profiling.host_read`` leaves
inside its spans, over the profiled stretch's queries
(``joinbench.spans``).  The benchmark's own readback is no program read
and is not counted."""

from joinbench import spans


def read(readings):
    att = spans.of(readings)
    if att is None:
        return None
    return sum(att.reads.values()) / att.queries
