"""native marshaller, in the stream (``runtime/stream.py``'s finish workers,
``inv._host_dequantize`` out of pinned buffers): the median ms of the
program's ``stream.dequantize`` spans in the profiled stretch, placed on the
trace's clock as ``stream_quantize_ms``'s."""

from gpubench.harness import program_spans


def read(cell, win):
    return program_spans.median_ms(win.summary, "stream.dequantize")
