"""native marshaller, in the stream (``runtime/stream.py``'s producer,
``inv._host_quantize`` into the pinned ring): the median ms of the program's
``stream.quantize`` spans in the profiled stretch.  The producer's spans are
in memory only; they are placed on the trace's clock by the main thread's
``run_raw`` spans (``harness/program_spans.py``)."""

from gpubench.harness import program_spans


def read(cell, win):
    return program_spans.median_ms(win.summary, "stream.quantize")
