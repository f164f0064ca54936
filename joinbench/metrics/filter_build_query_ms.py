"""filter_build_query_ms: device ms a query under every program span
``hbrj.bloom_build`` (the filter of R's keys), in planning and in
``full()`` alike, in the profiled stretch: the in-query twin of
``filter_build_ms`` (``joinbench.spans``)."""

from joinbench import spans


def read(readings):
    return spans.ms_under(readings, ("hbrj.bloom_build",))
