"""The program's own spans and counters, as the per-layer metrics read them.

The program records spans and counters in memory
(``matrix_inversion_tpu_torch.utils.profiling``: ``spans()``, ``counters()``).
A span on a thread that the profiler records is also in the trace, as a host
event ``mi.<name>``; a span of the stream's producer or finish workers is in
memory only.  Memory holds ``time.time_ns()``; the trace holds microseconds
from its start.  The main thread's ``run_raw`` spans are in both, so they give
the offset between the two clocks, and with it the worker spans' place in
the profiled stretch.

Every function here gives None where the program has no recorder (a program
older than its spans), where the trace holds none of its spans, or where the
offset is not steady: the readers then return None, never a wrong value.
"""

from __future__ import annotations

import statistics

PREFIX = "mi."
#: the most that the quartiles of the matched spans' offsets may lie apart
STEADY_US = 50.0


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from matrix_inversion_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "counters")):
        return None
    return profiling


def counter(name):
    """The program's counter ``name``, or None."""
    rec = recorder()
    return None if rec is None else rec.counters().get(name)


def traced(summary, name):
    """``[(start, end), ...]`` in µs of the trace's host events of the
    program's span ``name`` that lie wholly in the stretch, by start."""
    return sorted((e.start, e.end) for e in summary.host
                  if e.name == PREFIX + name and e.start >= summary.lo and e.end <= summary.hi)


def offset_ns(summary, spans):
    """ns to add to a span's ``time_ns()`` to place it on the trace's clock
    (µs from the trace's start, times 1e3): the median over the main
    thread's traced ``run_raw`` spans, the last of them in memory paired in
    order with the trace's ``mi.run_raw`` events, of the offsets of their
    starts and ends.  None where there are no such pairs, or where the
    offsets' quartiles lie more than :data:`STEADY_US` apart (a span's two
    clocks are read a few µs apart, but a thread switch between the two
    can part a single pair by ms)."""
    events = sorted((e.start, e.end) for e in summary.host if e.name == PREFIX + "run_raw")
    mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "run_raw" and s.traced)
    if not events or len(mine) < len(events):
        return None
    pairs = zip(mine[len(mine) - len(events):], events)
    offsets = [round(t * 1e3) - ns for (a, b), (s, e) in pairs for ns, t in ((a, s), (b, e))]
    q1, _, q3 = statistics.quantiles([o - offsets[0] for o in offsets], n=4)
    return statistics.median_low(offsets) if q3 - q1 <= STEADY_US * 1e3 else None


def mapped(summary, name):
    """``[(start, end), ...]`` in µs on the trace's clock of the program's
    in-memory spans ``name`` that lie wholly in the stretch, or None."""
    rec = recorder()
    if rec is None or summary is None:
        return None
    spans = rec.spans()
    off = offset_ns(summary, spans)
    if off is None:
        return None
    out = [((s.start_ns + off) / 1e3, (s.end_ns + off) / 1e3) for s in spans if s.name == name]
    return sorted((a, b) for a, b in out if a >= summary.lo and b <= summary.hi)


def median_ms(summary, name):
    """The median length in ms of the in-memory spans ``name`` in the
    stretch, or None."""
    spans = mapped(summary, name)
    return statistics.median((b - a) * 1e-3 for a, b in spans) if spans else None


def share_pct(summary, name):
    """The share, in percent, of the stretch inside the traced spans
    ``name`` (those of the thread that started the session), or None where
    the trace holds no ``run_raw`` span of the program."""
    if summary is None or not traced(summary, "run_raw") or summary.hi <= summary.lo:
        return None
    inside = sum(min(e.end, summary.hi) - max(e.start, summary.lo) for e in summary.host
                 if e.name == PREFIX + name and e.end > summary.lo and e.start < summary.hi)
    return 100.0 * inside / (summary.hi - summary.lo)
