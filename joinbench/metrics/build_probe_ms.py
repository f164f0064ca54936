"""build_probe_ms: the mean CUDA-event times of the plan's ``build`` and
``probe`` phases (bitmap or count tables, and the probe of S)."""


def read(readings):
    return readings.phases_ms(("build", "probe"))
