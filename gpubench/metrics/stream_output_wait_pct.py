"""stream (``runtime/stream.py``'s consumer): the share, in percent, of the
profiled stretch that the consumer spent waiting for the oldest batch's
finish job (the program's ``stream.output_wait`` spans, in the trace as
``mi.stream.output_wait``).  Large when the finish workers set the pace."""

from gpubench.harness import program_spans


def read(cell, win):
    return program_spans.share_pct(win.summary, "stream.output_wait")
