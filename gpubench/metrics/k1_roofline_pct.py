"""K1 (``ops/fused_inverse.py`` -> ``csrc/fused_inverse*.cu``): the least time
a call's inversions could take on the card, over the device time of every
kernel, copy and fill that the call's ``run_raw`` launched, in percent.

The least time is the larger of the configuration's frozen count of 32-bit
instructions an inversion over the published issue limit and its bytes an
inversion over the published memory bandwidth (``roofline`` in the
configuration's file), times the batch.  It counts the function's work, not
the kernel's, so it reads the same work whatever kernels carry it."""


def read(cell, win):
    s = win.summary
    calls = s.span_count("run_raw") if s is not None else 0
    launched = s.launched_by("run_raw") if calls else []
    if not launched:
        return None
    roof = cell.config["roofline"]
    batch = cell.traffic["batch"]
    bound_s = max(roof["instructions_per_inversion"] * batch / roof["issue_rate_per_s"],
                  roof["bytes_per_inversion"] * batch / roof["memory_bytes_per_s"])
    device_s = sum(e.end - e.start for e in launched) * 1e-6 / calls
    return 100.0 * bound_s / device_s
