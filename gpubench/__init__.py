"""Benchmark of matrix_inversion_tpu_torch on NVIDIA cards.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own, found by
its name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (read by the
driver ``drivers/<driver>.py`` it names) and ``metrics/<metric>.py``.
``reference/`` is the plain PyTorch reference that decides ``correct``.
"""
