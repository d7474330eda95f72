"""The benchmark of ``recsys_tpu_torch`` (``python3 bench_port/run.py``).

Everything a cell, a configuration or a per-layer metric needs sits in a
file of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py`` and
``layer_metrics/<metric>.py``. The yardstick (traffic, data and weights
from the seed, the work counts, the peaks, the trace reduction, the plain
reference and the comparison that decides ``correct``) lives here too and
imports nothing of the JAX package.
"""
