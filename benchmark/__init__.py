"""The benchmark of ``correrender_tpu_torch`` on one NVIDIA GPU.

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix, cell, per-layer metric or
kernel bound is a file of its own, found by its name: ``configs/``,
``traffic/``, ``workloads/``, ``metrics/``, ``bounds/``; so is the code
a cell's files name: ``drivers/`` (how a configuration is served),
``interactions/`` (what a mix moves) and ``reference/`` (the plain
references that decide ``correct``).
"""
