"""filter_build_ms: the mean CUDA-event time of the plan's ``bloom_build``
phase (the bloom filter of R's keys)."""


def read(readings):
    return readings.phases_ms(("bloom_build",))
