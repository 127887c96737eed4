"""runtime api (``runtime/api.py::run_raw``): the mean over the profiled
stretch's calls of the µs from the start of the program's ``run_raw`` span
(``mi.run_raw`` in the trace) to the first kernel launch of the runtime
(``cu...Launch...``) inside it: the host's time before the card can start,
which a closed loop leaves idle."""

import bisect
import statistics

from gpubench.harness import program_spans


def read(cell, win):
    s = win.summary
    calls = program_spans.traced(s, "run_raw") if s is not None else []
    launches = sorted(e.start for e in s.host if e.name.startswith("cu")
                      and "Launch" in e.name) if calls else []
    leads = []
    for start, end in calls:
        i = bisect.bisect_left(launches, start)
        if i < len(launches) and launches[i] <= end:
            leads.append(launches[i] - start)
    return statistics.fmean(leads) if leads else None
