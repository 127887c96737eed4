"""runtime api (``runtime/api.py::run_raw``): host ms from the call to its
return, the mean over the window's calls after the profiled stretch (the
driver's ``run_raw_host`` span)."""

import statistics


def read(cell, win):
    ms = win.spans.get("run_raw_host")
    return statistics.fmean(ms) if ms else None
