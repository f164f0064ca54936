"""Distributed execution on torch.distributed: one process a device, the
relations hash-partitioned across them.

Counterpart of ``hwbloomradixjoin_tpu/parallel/``, which runs one SPMD
program over a JAX device mesh.  Here every device is a process of a
``torch.distributed`` group (``mesh.py``); histograms and results are
all_reduced, the partition shuffle is an ``all_to_all_single``
(``dist_join.py``), heavy destinations are split (``skew.py``), and
``multiproc.py`` launches and checks a world of processes.
"""
