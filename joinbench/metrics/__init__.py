"""Per-layer metrics, one module a metric, found by the metric's name.

Each module's ``read(readings)`` takes the traced run's
``joinbench.trace.Readings`` and returns the metric's value, or None when
the run holds nothing for it to read (the harness then leaves the metric
out of the result line).
"""
