"""filter_prune_ms: the mean CUDA-event times of the plan's prune of S by
the filter, ``bloom_partition`` (the hash partition) plus ``bloom_probe``,
whichever the plan has."""


def read(readings):
    return readings.phases_ms(("bloom_partition", "bloom_probe"))
