"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one GPU and
prints one JSON result line. Everything that belongs to one configuration,
traffic mix, cell or metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``.
"""
