"""Benchmark of the PyTorch and CUDA port (``repro_torch``): sparse LU
refactorize-and-solve as a circuit simulator drives it.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, metric or
cell lives in a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``, and the matrix and value
rules the configurations and mixes name, ``rules/<rule>.py``.
"""
