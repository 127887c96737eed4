"""builds (``ops/cuda_build.py``, the loads in ``ops/fused_inverse.py`` and
``runtime/native.py``): the s the program spent building or loading its
libraries, the emitter and the hash included, up to the end of the window
(the program's ``library.ns`` counter)."""

from gpubench.harness import program_spans


def read(cell, win):
    ns = program_spans.counter("library.ns")
    return ns * 1e-9 if ns else None
