"""partition_query_ms: device ms a query under every program span
``hbrj.r_partition``, ``hbrj.compact``, ``hbrj.s_partition`` and
``hbrj.s_pass2``, in planning and in ``full()`` alike, in the profiled
stretch: the in-query twin of ``partition_ms`` (``joinbench.spans``)."""

from joinbench import spans


def read(readings):
    return spans.ms_under(readings, ("hbrj.r_partition", "hbrj.compact",
                                     "hbrj.s_partition", "hbrj.s_pass2"))
