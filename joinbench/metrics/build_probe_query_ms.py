"""build_probe_query_ms: device ms a query under every program span
``hbrj.build`` and ``hbrj.probe`` (the bitmap or count tables, and the
probe of S), in planning and in ``full()`` alike, in the profiled stretch:
the in-query twin of ``build_probe_ms`` (``joinbench.spans``)."""

from joinbench import spans


def read(readings):
    return spans.ms_under(readings, ("hbrj.build", "hbrj.probe"))
