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


def device_work_by_range(events, labels, prefix="step:"):
    """``{label: {name: count}}``: the device work of a trace (the
    ``FunctionEvent``s of ``prof.events()``) by the host range named
    ``prefix + label`` that holds its launch.

    A kernel, copy or fill on the device shares its correlation id with
    the runtime call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...) that queued it; the call runs on the host, so
    the host span of a ``record_function`` range says whether the range
    queued the work, whatever the device's clock.  The device-side
    annotation that the profiler adds under each range's name is left out:
    its span follows the device.  Raises if a label's host range is missing
    or there twice, or if device work has no launching call or its calls
    lie in no range or in more than one."""
    cpu = torch.autograd.DeviceType.CPU
    ranges, calls = {}, {}
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name.startswith(prefix):
            label = e.name[len(prefix):]
            if label in ranges:
                raise ValueError(f"the trace holds the host range {e.name!r} twice")
            ranges[label] = e.time_range
        elif e.name.startswith("cu"):
            calls.setdefault(e.id, []).append(e.time_range.start)
    if set(ranges) != set(labels):
        raise ValueError(f"the trace holds the host ranges {sorted(ranges)}, not {sorted(labels)}")
    ran = {label: {} for label in labels}
    for e in events:
        if e.device_type == cpu or e.name.startswith(prefix):
            continue
        if e.id not in calls:
            raise ValueError(f"device work {e.name} (correlation {e.id}) has no launching call")
        owners = {label for label, r in ranges.items() for t in calls[e.id] if r.start <= t <= r.end}
        if len(owners) != 1:
            raise ValueError(f"device work {e.name} was launched in the ranges {sorted(owners)}")
        counts = ran[owners.pop()]
        counts[e.name] = counts.get(e.name, 0) + 1
    return ran


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
