"""join_roofline_share: the query's least time (``joinbench.costs``: its
input columns read once and its result written once at the card's peak
bandwidth) over its device busy time (the union of device operations in
the profiled stretch, a query), in %."""

from joinbench import costs


def read(readings):
    st = readings.stretch
    if st.busy_s <= 0:
        return None
    least = costs.least_seconds(readings.config, readings.traffic,
                                   readings.card)
    return 100.0 * least / (st.busy_s / st.queries)
