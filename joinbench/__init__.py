"""The benchmark of the PyTorch and CUDA port (``hwbloomradixjoin_tpu_torch``).

``python -m joinbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line.  Configurations, traffic and per-layer metrics are
data and small modules found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.
"""
