"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix, cell
or metric is a file of its own under ``configs/``, ``traffic/``,
``workloads/`` and ``metrics/``, found by its name.
"""
