"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations, traffic mixes and per-layer metrics are files
found by name (``configs/``, ``traffic/``, ``metrics/``); the plain
reference that decides ``correct`` lives in ``reference/`` and imports
nothing of the port.
"""
