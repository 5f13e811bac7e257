"""rtabench: the benchmark of ``basicrta_torch`` on one NVIDIA H100.

Run one cell from the root of a checkout::

    python3 -m rtabench --workload w313.tau --seed 1 --seconds 51 --trace 0

See ``rtabench/harness.py`` for what a run does and prints, and
``PERF.md`` for the cells, the metrics and how ``correct`` is decided.
"""
