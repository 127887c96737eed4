"""Observability: device profiling traces and the circuit's op statistics.

Port of ``matrix_inversion_tpu/utils/profiling.py``.  The reference's
observability is wall-clock prints and the QFloat class counters
(reference qfloat.py:262-326, qfloat_matrix_inversion.py:747-755); here
those are kept (``QFloatBase.show_stats``) and extended with
``torch.profiler`` traces for attribution by kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from ..core.qfloat import QFloatBase


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    where there is a card) and write it on exit as a Chrome trace,
    ``<logdir>/trace.json``, viewable in Perfetto.  Yields the profiler, so
    that the caller can read ``key_averages()`` afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, results: dict = None):
    """Wall-clock section timer; appends to ``results`` when given."""
    start = time.time()
    yield
    elapsed = time.time() - start
    if results is not None:
        results[label] = elapsed
    else:
        print(f"|  {label} : {elapsed:.2f} s  |")


def circuit_stats(fn, *example_args):
    """Run ``fn`` once and report the QFloat op counts of its circuit.

    The counterpart of building with ``QFloat.reset_stats()`` /
    ``show_stats()`` around it (reference qfloat_matrix_inversion.py:
    1250-1281).  PyTorch has no shape-only evaluation, so ``fn`` really
    runs: give it tiny CPU tensors.  The counters are process globals.
    """
    QFloatBase.reset_stats()
    fn(*example_args)
    return {
        "additions": QFloatBase.ADDITIONS,
        "multiplications": QFloatBase.MULTIPLICATION,
        "divisions": QFloatBase.DIVISION,
    }


def dump_stats(stats: dict, path: str = None):
    line = json.dumps(stats)
    if path:
        with open(path, "a") as fh:
            fh.write(line + "\n")
    return line
