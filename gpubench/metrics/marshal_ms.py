"""native marshaller (``runtime/native.py`` -> ``csrc/qmarshal.cc``): ms of
the stream's own host calls on one pool batch, the producer's quantize into
pinned buffers plus a finish worker's dequantize out of pinned buffers, each
timed alone after the window, not under the stream; the median of the
driver's ``marshal_alone`` span."""

import statistics


def read(cell, win):
    ms = win.spans.get("marshal_alone")
    return statistics.median(ms) if ms else None
