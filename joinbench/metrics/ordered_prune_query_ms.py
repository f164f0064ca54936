"""ordered_prune_query_ms: device ms a query under every program span
``hbrj.ordered_prune`` (the order-preserving prune of S by the filter:
filter build, probe and PAD write, keys left in S's order beside their
payloads), in planning and in ``full()`` alike, in the profiled stretch
(``joinbench.spans``).  None where the program has no such span."""

from joinbench import spans


def read(readings):
    return spans.ms_under(readings, ("hbrj.ordered_prune",))
