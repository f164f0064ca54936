"""filter_prune_query_ms: device ms a query under every program span
``hbrj.bloom_partition`` and ``hbrj.bloom_probe`` (the prune of S by the
filter), in planning and in ``full()`` alike, in the profiled stretch: the
in-query twin of ``filter_prune_ms`` (``joinbench.spans``)."""

from joinbench import spans


def read(readings):
    return spans.ms_under(readings, ("hbrj.bloom_partition",
                                     "hbrj.bloom_probe"))
