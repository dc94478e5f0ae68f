"""The benchmark of ``summer_clip_torch`` on NVIDIA H100 cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once. ``BENCHMARK.json`` at the repository's root lists
the cells and metrics; each cell, configuration, driver and per-layer metric
is a file of its own here, found by its name (``PERF.md``, "Adding a cell or
a metric").
"""
