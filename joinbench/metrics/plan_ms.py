"""plan_ms: the mean host time of ``registry.plan_join`` over the traced
run's queries, from the benchmark's span around the call.  The planner ends
in host reads, so the span closes on the device's planning work."""


def read(readings):
    if not readings.plan_s:
        return None
    return 1e3 * sum(readings.plan_s) / len(readings.plan_s)
