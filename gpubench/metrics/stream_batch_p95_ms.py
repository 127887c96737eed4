"""stream (``runtime/stream.py::StreamingInverter``): the 95th percentile of
the time from the producer's pull of a batch to its floats out, over the
window's batches after the profiled stretch (the driver's ``batch_latency``
span).  The stream runs saturated (the producer pulls as fast as the stream
takes), so the time is mostly each batch's wait in the stream's queue: it
swings with the smallest change of the rate and is a layer's reading, not an
end-to-end one."""

from gpubench.harness import stats


def read(cell, win):
    ms = win.spans.get("batch_latency")
    return stats.percentile(ms, 95) if ms else None
