"""digit I/O (``models/inverse.py``: pack and unpack around K1): device ms a
call of the work that ``run_raw`` launched other than K1, whose kernel
symbols the configuration's file lists under ``k1_kernels`` (matched as a
whole name, demangled or mangled: no letter or ``_`` touches it)."""

import re


def read(cell, win):
    s = win.summary
    calls = s.span_count("run_raw") if s is not None else 0
    if not calls:
        return None
    names = "|".join(map(re.escape, cell.config["k1_kernels"]))
    k1 = re.compile(rf"(^|[^A-Za-z_])({names})($|[^A-Za-z_])")
    other = [e for e in s.launched_by("run_raw") if not k1.search(e.name)]
    if not other:
        return None
    return sum(e.end - e.start for e in other) * 1e-3 / calls
