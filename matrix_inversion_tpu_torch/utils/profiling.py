"""Observability: the port's spans and counters, device profiling traces, and
the circuit's op statistics.

Port of ``matrix_inversion_tpu/utils/profiling.py``.  The reference's
observability is wall-clock prints and the QFloat class counters
(reference qfloat.py:262-326, qfloat_matrix_inversion.py:747-755); here
those are kept (``QFloatBase.show_stats``) and extended with
``torch.profiler`` traces for attribution by kernel, and with the port's own
spans and counters.

**Spans.** ``with span("stream.quantize", batch=k):`` records the span's
name, thread, start and end (``time.time_ns()``, the clock of the profiler's
events: ``trace_start_ns()`` plus their offsets), the enclosing span on the
same thread and its ids, in memory (:func:`spans`, at most
:data:`CAPACITY`; the rest are counted under ``spans.dropped``).  A span
records on a thread while a ``torch.profiler`` session records that thread,
and there it also opens a profiler range ``mi.<name>``, so that the trace
holds it natively; and on a thread that :func:`following` switched on, as
``StreamingInverter`` does for the workers of a run begun under a session
(the profiler does not see those threads).  Otherwise a span is one check
and a shared no-op context.  The range has the profiler's function scope,
not the user scope of ``record_function``: a user range also stands on the
device's timeline as an annotation over the work launched inside it.

**Counters** are always on: ``launch.<kernel>`` for each launch of a
hand-written kernel, ``lanes.matrix_lanes`` and ``lanes.launched_lanes`` (the
lanes that K1's lanes design fills with a matrix's rows, B*n a launch, and
the lanes it launches, its blocks' threads: their ratio is the share of the
launched warps the design fills), ``k1.closed_form_matrices`` (the matrices
of each K1 launch at n = 2, whose straight-line body is the closed form
adj(M)/det(M)), ``library.built`` and ``library.loaded`` (the misses
and hits of ``ops/cuda_build.py``'s cache) and ``library.ns`` (ns spent in
building or loading a library, the emitter and the hash included,
:func:`library`), and ``stream.device_marshal`` and ``stream.host_marshal``
(``runtime/stream.py``'s batches by the route they took: quantized and
dequantized on the card, or on the host).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

import torch

PREFIX = "mi."
#: most spans kept in memory; later ones are counted under ``spans.dropped``
CAPACITY = 1 << 16

#: one recorded span: ``parent`` the name of the enclosing span on the same
#: thread (None at the top), ``ids`` such as ``{"batch": 3}``, ``traced``
#: whether the profiler's trace holds it as ``mi.<name>``
Span = collections.namedtuple("Span", "name thread start_ns end_ns parent ids traced")

_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_spans = []
_counters = {}
_lock = threading.Lock()


class _Thread(threading.local):
    """One thread's state: whether its spans record without a session
    (``follow``), the ids its spans carry, its open spans, and whether it is
    inside a library's load.  The class attributes are every thread's
    defaults, so that reading them costs no exception."""

    follow = False
    ids = None
    loading = False

    def __init__(self):
        self.stack = []


_local = _Thread()


def tracing():
    """Whether spans record on this thread now."""
    return _profiling() or _local.follow


class _Open:
    __slots__ = ("name", "ids", "range", "parent", "start")

    def __init__(self, name, ids, traced):
        tagged = _local.ids
        self.name = name
        self.ids = {**tagged, **ids} if tagged else ids
        self.range = _Range(PREFIX + name) if traced else None

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        if self.range is not None:
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        record = Span(self.name, threading.current_thread().name, self.start, end,
                      self.parent, self.ids, self.range is not None)
        with _lock:
            if len(_spans) < CAPACITY:
                _spans.append(record)
            else:
                _counters["spans.dropped"] = _counters.get("spans.dropped", 0) + 1
        return False


def span(name, **ids):
    """A context that records one span (see the module's docstring), or a
    shared no-op context where spans do not record."""
    if _profiling():
        return _Open(name, ids, True)
    if _local.follow:
        return _Open(name, ids, False)
    return _OFF


class _Set:
    """Sets one attribute of this thread's state for a ``with`` block."""

    __slots__ = ("key", "value", "old")

    def __init__(self, key, value):
        self.key, self.value = key, value

    def __enter__(self):
        self.old = getattr(_local, self.key)
        setattr(_local, self.key, self.value)

    def __exit__(self, *exc):
        setattr(_local, self.key, self.old)
        return False


def tagged(**ids):
    """A context in which the spans this thread opens carry ``ids`` too
    (where spans record; else a no-op)."""
    if not tracing():
        return _OFF
    return _Set("ids", {**(_local.ids or {}), **ids})


def following(on):
    """A context in which spans record on this thread if ``on``, whether
    or not the profiler sees the thread: for worker threads of a run begun
    under a session."""
    return _Set("follow", bool(on))


def count(name, k=1):
    """Add ``k`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + k


def launches(kernel):
    """The ``launch.<kernel>`` counter, 0 before the first launch."""
    return _counters.get("launch." + kernel, 0)


def spans():
    """The spans recorded since the last :func:`reset`, oldest first."""
    return list(_spans)


def counters(prefix=""):
    """The counters since the last :func:`reset` whose names start with
    ``prefix``."""
    with _lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset():
    """Clear the spans and the counters."""
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def library(name):
    """Time one library's build or load (``library.ns``, and a ``library``
    span with ``lib=name``); inside another on the same thread, only the
    outermost counts."""
    if _local.loading:
        yield
        return
    _local.loading = True
    start = time.perf_counter_ns()
    try:
        with span("library", lib=name):
            yield
    finally:
        _local.loading = False
        count("library.ns", time.perf_counter_ns() - start)


def _untraced_events(base_ns, lo_ns, hi_ns):
    """Chrome trace events of the spans that the profiler did not record
    and that lie in ``[lo_ns, hi_ns]``, one lane per thread, with ``ts`` in
    µs from ``base_ns``."""
    lanes, events = {}, []
    for s in spans():
        if s.traced or s.start_ns < lo_ns or s.end_ns > hi_ns:
            continue
        if s.thread not in lanes:
            lanes[s.thread] = tid = -1 - len(lanes)
            events.append({"ph": "M", "name": "thread_name", "pid": os.getpid(), "tid": tid,
                           "args": {"name": f"{s.thread} (mi spans)"}})
        events.append({"ph": "X", "cat": "mi_span", "name": PREFIX + s.name, "pid": os.getpid(),
                       "tid": lanes[s.thread], "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {**s.ids, "parent": s.parent}})
    return events


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    where there is a card) and write it on exit as a Chrome trace,
    ``<logdir>/trace.json``, viewable in Perfetto, with the session's spans
    of threads that the profiler did not record beside it, on the trace's
    clock, one lane per thread.  Yields the profiler, so that the caller
    can read ``key_averages()`` afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        hi_ns = time.time_ns()
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        trace["traceEvents"] += _untraced_events(
            trace.get("baseTimeNanoseconds", 0),
            prof.profiler.kineto_results.trace_start_ns(), hi_ns)
        with open(path, "w") as fh:
            json.dump(trace, fh)


def device_work_by_range(events, labels, prefix="step:", key=lambda e: e.name):
    """``{label: {key: count}}``: the device work of a trace (the
    ``FunctionEvent``s of ``prof.events()``) by the host range named
    ``prefix + label`` that holds its launch, counted under ``key(event)``
    (the kernel's name; ``(e.name, e.device_index)`` counts by card too).

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
        counts[key(e)] = counts.get(key(e), 0) + 1
    return ran


def circuit_stats(fn, *example_args):
    """Run ``fn`` once and report the QFloat op counts of its circuit.

    The counterpart of building with ``QFloat.reset_stats()`` /
    ``show_stats()`` around it (reference qfloat_matrix_inversion.py:
    1250-1281).  PyTorch has no shape-only evaluation, so ``fn`` really
    runs: give it tiny CPU tensors.  The counters are process globals.
    """
    from ..core.qfloat import QFloatBase

    QFloatBase.reset_stats()
    fn(*example_args)
    return {
        "additions": QFloatBase.ADDITIONS,
        "multiplications": QFloatBase.MULTIPLICATION,
        "divisions": QFloatBase.DIVISION,
    }
