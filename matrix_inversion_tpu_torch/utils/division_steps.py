"""The steps of the division kernels' design, timed side by side.

``csrc/long_division_steps.cu`` holds, beside the frame and the element
functions that the port launches (``csrc/long_division.cu``, included
whole), what they replaced: the first frame (one element per thread) and
the first K2 and K3, and the card's own 64-bit ``/``.  :func:`measure`
checks every step against ``torch.div`` on the timed inputs (tolerance 0)
and times them in turns within one process, at the High true division
(60 bits by a divisor below 2**40, ``k`` = 15) and the High reciprocal (the
one word 2**60 by the same divisors, 61 bits), with ``torch.div`` beside
them.  Nothing of the port's paths calls this module.

    python -m matrix_inversion_tpu_torch.utils.division_steps [--out PATH]

prints one JSON line per step and shape (to ``PATH`` as well, if given).
"""

from __future__ import annotations

import ctypes
import functools
import json
import statistics
import sys
import time

import torch

from ..ops.cuda_build import CSRC, NVCC_FLAGS, build_library
from ..ops.long_division import division_operands
from ..ops.packed import packed_long_division_reference
from .timing import card_name_and_limit

FRAMES = {"one element per thread": 0, "streaming, 1 pair": 1, "streaming, 2 pairs": 2}
OPS = {"first K2": 0, "first K3": 1, "K2 run-time": 2, "K2 compile-time": 3, "K3": 4,
       "the card's /": 5}

# (label, frame, element function), each step beside the one before it
STEPS = [
    ("K2 as first ported", "one element per thread", "first K2"),
    ("K2 step 1: the frame, 1 pair", "streaming, 1 pair", "first K2"),
    ("K2 step 1: the frame, 2 pairs", "streaming, 2 pairs", "first K2"),
    ("K2 step 3: 32-bit conversions, run-time (n_bits, k)", "streaming, 2 pairs", "K2 run-time"),
    ("K2 step 3: and compile-time (n_bits, k), 1 pair", "streaming, 1 pair", "K2 compile-time"),
    ("K2 step 3: and compile-time (n_bits, k)", "streaming, 2 pairs", "K2 compile-time"),
    ("K2 step 3 in the first frame", "one element per thread", "K2 compile-time"),
    ("K3 as first ported", "one element per thread", "first K3"),
    ("K3 step 1: the frame, 2 pairs", "streaming, 2 pairs", "first K3"),
    ("K3 step 2: integer reciprocal, 1 pair", "streaming, 1 pair", "K3"),
    ("K3 step 2: integer reciprocal", "streaming, 2 pairs", "K3"),
    ("K3 step 2 in the first frame", "one element per thread", "K3"),
    ("the card's 64-bit / in the frame", "streaming, 2 pairs", "the card's /"),
]


def _build():
    return build_library(
        "long_division_steps.cu", "liblong_division_steps.so",
        tuple((CSRC / name).read_text() for name in
              ("qfloat_cell.cuh", "long_division.cu", "long_division_steps.cu"))
        + (" ".join(NVCC_FLAGS),),
    )


@functools.lru_cache(maxsize=None)
def _library():
    fn = ctypes.CDLL(str(_build())).division_step_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build the library (one nvcc) and load it."""
    _library()


def library_path():
    """The built library (its SASS holds the first K2 and K3 too).  Builds
    first if needed."""
    return _build()


def run_step(frame, op, dividend, divisor, n_bits, k, out=None):
    """One launch of element function ``op`` (a key of ``OPS``) in frame
    ``frame`` (a key of ``FRAMES``) on CUDA tensors, operands as the division
    wrappers take them; returns the quotients (written into ``out`` if
    given)."""
    v, v_stride, d = division_operands(dividend, divisor)
    if d.device.type != "cuda":
        raise ValueError(f"the steps run on the card and take CUDA tensors only, got {d.device}")
    out = torch.empty_like(d) if out is None else out
    with torch.cuda.device(d.device):
        err = _library()(FRAMES[frame], OPS[op], v.data_ptr(), d.data_ptr(), out.data_ptr(),
                         d.numel(), v_stride, n_bits, k, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"division step ({frame}, {op}) failed to launch: error {err}")
    return out


def _event_ms(fn, launches):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def measure(device="cuda", elems=16_777_216, rounds=15, launches=10, seed=21, warm_up_s=1.0):
    """Rows ``{"step", "frame", "op", "shape", "ms", "bytes_per_element"}``
    for every step at both shapes, and ``torch.div`` (floor) as the last row
    of each: the median of ``rounds`` CUDA-event timings of ``launches``
    launches (the queue then hides the host's part of a launch), taken in
    turns (every step once, ``rounds`` times over) after ``warm_up_s``
    seconds of launches, so that the card's clocks are up.  Raises if a
    step's quotients differ from ``torch.div``'s anywhere."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.randint(1, 1 << 40, (elems,), dtype=torch.int64, device=device, generator=g)
    shapes = [
        ("divide", torch.randint(0, 1 << 60, (elems,), dtype=torch.int64, device=device,
                                 generator=g), 60, 24),
        ("reciprocal", torch.full((), 1 << 60, dtype=torch.int64, device=device), 61, 16),
    ]
    out = torch.empty_like(d)
    rows = []
    for shape, v, n_bits, moved in shapes:
        ref = packed_long_division_reference(v, d, n_bits)
        runs = {}
        for label, frame, op in STEPS:
            runs[label] = functools.partial(run_step, frame, op, v, d, n_bits, 15, out)
            got = runs[label]()
            assert torch.equal(got, ref), f"{label} ({shape}) differs from torch.div"
        runs["torch.div floor"] = lambda: torch.div(v, d, rounding_mode="floor", out=out)
        samples = {label: [] for label in runs}
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < warm_up_s:
            for fn in runs.values():
                fn()
            torch.cuda.synchronize(device)
        for _ in range(rounds):
            for label, fn in runs.items():
                samples[label].append(_event_ms(fn, launches))
        for label, frame, op in STEPS + [("torch.div floor", None, None)]:
            rows.append({"step": label, "frame": frame, "op": op, "shape": shape,
                         "elements": elems, "ms": statistics.median(samples[label]),
                         "bytes_per_element": moved})
    return rows


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    if not torch.cuda.is_available():
        print("division_steps: no CUDA device", file=sys.stderr)
        return 1
    card = card_name_and_limit()
    lines = [json.dumps({**row, "card": card}) for row in measure()]
    print("\n".join(lines))
    if out_path:
        with open(out_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
