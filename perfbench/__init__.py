"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py``, and per operation
``reference/<op>.py``, ``costs/<op>.py`` and ``programs/<op>.py``.
"""
