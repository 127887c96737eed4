"""runtime api (``runtime/api.py::run_raw``): the device operations (kernels,
copies, fills) whose runtime call lies inside one of the program's
``run_raw`` spans (``mi.run_raw`` in the trace) in the profiled stretch,
divided by those spans: the launches a call makes, which repeat exactly."""

import bisect

from gpubench.harness import program_spans


def read(cell, win):
    s = win.summary
    calls = program_spans.traced(s, "run_raw") if s is not None else []
    if not calls:
        return None
    starts = {e.corr: e.start for e in s.host if e.name.startswith("cu")}
    ops = [e for e in s.device if e.corr in starts]
    if not ops:
        return None

    def inside(t):
        i = bisect.bisect_right(calls, (t, float("inf"))) - 1
        return i >= 0 and calls[i][0] <= t <= calls[i][1]
    return sum(inside(starts[e.corr]) for e in ops) / len(calls)
