"""partition_ms: the mean CUDA-event times of the plan's partition phases,
``r_partition``, ``compact``, ``s_partition`` and ``s_pass2``, whichever
the plan has."""


def read(readings):
    return readings.phases_ms(("r_partition", "compact", "s_partition",
                               "s_pass2"))
