"""plan_device_ms: device busy ms a query (the union of the operations'
intervals) of the operations launched under the program's span
``hbrj.plan_join``, the planner's own work before ``full()``, in the
profiled stretch (``joinbench.spans``)."""

from joinbench import spans


def read(readings):
    return spans.ms_under(readings, ("hbrj.plan_join",))
