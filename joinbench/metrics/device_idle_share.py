"""device_idle_share: the share of the profiled stretch of whole queries,
from the first query's start to the last one's end on the host, in which
no device operation runs, in %."""


def read(readings):
    st = readings.stretch
    if st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
