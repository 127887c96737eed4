"""stream (``runtime/stream.py``'s consumer): the share, in percent, of the
profiled stretch that the consumer spent waiting for the producer's next
batch (the program's ``stream.input_wait`` spans, in the trace as
``mi.stream.input_wait``).  Large when the producer sets the pace."""

from gpubench.harness import program_spans


def read(cell, win):
    return program_spans.share_pct(win.summary, "stream.input_wait")
