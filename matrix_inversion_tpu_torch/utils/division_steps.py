"""The steps of the op-by-op kernels' design, timed side by side.

``csrc/long_division_steps.cu`` holds, beside the frame and the element
functions that the port launches (``csrc/long_division.cu`` and
``csrc/mul_window.cu``, included whole), what they replaced: the first
frame (one element per thread) and the first K2, K3 and K4 (K4's rows read
from a table, :class:`MulWindowTable`), the card's own 64-bit ``/``, and
the forms of K4 between its first and its present one.  :func:`measure`
checks every division step against ``torch.div`` and every multiply step
against the port's K4 on the timed inputs (tolerance 0) and times them in
turns within one process, at the High true division (60 bits by a divisor
below 2**40, ``k`` = 15), the High reciprocal (the one word 2**60 by the
same divisors, 61 bits), with ``torch.div`` beside them, and the High dot
product's multiply ((40, 20) x (40, 20) -> (40, 20)).  :func:`step_info`
reads a multiply step's registers, spills and SASS.  Nothing of the port's
paths calls this module.

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
from ..ops.long_division import batched_mul_window, division_operands, mul_trunc_format
from ..ops.packed import mul_window_consts, packed_long_division_reference
from . import sass
from .timing import card_name_and_limit, card_state

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

MUL_OPS = {"first K4": 0, "K4 in 128 bits, run-time format": 1,
           "K4 32-bit C, run-time format": 2, "K4 High instance": 3}

# The multiply's steps, each beside the one before it; the last is the
# port's kernel
MUL_STEPS = [
    ("K4 as first ported (row table)", "one element per thread", "first K4"),
    ("K4 step 1: the row table in the streaming frame", "streaming, 2 pairs", "first K4"),
    ("K4 step 2: the algebraic form in 128 bits (K1's mul_inl), run-time format",
     "streaming, 2 pairs", "K4 in 128 bits, run-time format"),
    ("K4 step 3: C in 32 bits and the low 64 bits of a*b, run-time format",
     "streaming, 2 pairs", "K4 32-bit C, run-time format"),
    ("K4 step 4: High's compile-time instance = the port's kernel", "streaming, 2 pairs",
     "K4 High instance"),
]

# The High dot product's multiply: (len, ints) of a, of b, of the product
HIGH_MUL = ((40, 20), (40, 20), (40, 20))

# A kernel's name in the library's SASS and ptxas log holds these: its
# frame's template and its element function's type
_FRAME_KERNEL = {0: "scalar_kernel", 1: "stream_kernelILi1E", 2: "stream_kernelILi2E"}
_MUL_OP_TYPE = {0: "8FirstMul", 1: "TruncAnyIooE", 2: "TruncAnyIjmE",
                3: "TruncFixedILi20ELi20ELi40E"}
_ELEMS_PER_THREAD = {0: 1, 1: 2, 2: 4}

_MAX_ROWS = 62  # csrc/long_division_steps.cu kMaxRows


class MulWindowTable(ctypes.Structure):
    """The first K4's table, laid out as ``MulWindowTable`` in
    csrc/long_division_steps.cu."""

    _fields_ = [
        ("b_mask", ctypes.c_uint64 * _MAX_ROWS),
        ("out_mask", ctypes.c_uint64),
        ("a_shift", ctypes.c_int32 * _MAX_ROWS),
        ("b_shift", ctypes.c_int32 * _MAX_ROWS),
        ("out_shift", ctypes.c_int32 * _MAX_ROWS),
        ("rows", ctypes.c_int32),
    ]


def mul_window_table(consts, newlength):
    """The first K4's table of one call: the rows of ``consts``
    (:func:`~..ops.packed.mul_window_consts`) that add a partial product,
    and the base-2 output mask of ``newlength`` digits."""
    rows = [c for c in consts if c[2] != 0]
    if len(rows) > _MAX_ROWS:
        raise ValueError(f"the first K4 takes at most {_MAX_ROWS} partial products")
    table = MulWindowTable()
    for i, (a_sh, b_sh, b_mask, o_sh) in enumerate(rows):
        table.a_shift[i], table.b_shift[i] = a_sh, b_sh
        table.b_mask[i], table.out_shift[i] = b_mask, o_sh
    table.rows = len(rows)
    table.out_mask = (1 << newlength) - 1
    return table


@functools.lru_cache(maxsize=None)
def mul_step_args(a_fmt, b_fmt, out_fmt):
    """The arguments after ``a_stride`` of one ``mul_step`` call at these
    formats: ``(t1, nt, newlength, table)``.  Built once per format: the
    table takes longer in Python than the fastest step takes on the card,
    so building it at each launch would time the host."""
    (al, ai), (bl, bi), (nl, ni) = a_fmt, b_fmt, out_fmt
    t1, nt, _ = mul_trunc_format(al, ai, bl, bi, nl, ni)
    table = mul_window_table(mul_window_consts(al, ai, bl, bi, nl, ni, 1), nl)
    return t1, nt, nl, ctypes.byref(table)


def _build():
    return build_library(
        "long_division_steps.cu", "liblong_division_steps.so",
        tuple((CSRC / name).read_text() for name in
              ("qfloat_cell.cuh", "stream_frame.cuh", "long_division.cu", "mul_window.cu",
               "long_division_steps.cu"))
        + (" ".join(NVCC_FLAGS),),
    )


@functools.lru_cache(maxsize=None)
def _library():
    """``(division_step_launch, mul_step_launch)``."""
    lib = ctypes.CDLL(str(_build()))
    div, mul = lib.division_step_launch, lib.mul_step_launch
    # (frame, op, x, y, out, n, x_stride, the kernel's parameters, [table,] stream)
    div.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    mul.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [
        ctypes.c_int] * 4 + [ctypes.POINTER(MulWindowTable), ctypes.c_void_p]
    for fn in (div, mul):
        fn.restype = ctypes.c_int
    return div, mul


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
        err = _library()[0](FRAMES[frame], OPS[op], v.data_ptr(), d.data_ptr(), out.data_ptr(),
                            d.numel(), v_stride, n_bits, k, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"division step ({frame}, {op}) failed to launch: error {err}")
    return out


def run_mul_step(frame, op, a, b, formats=HIGH_MUL, out=None):
    """One launch of multiply element function ``op`` (a key of
    ``MUL_OPS``) in frame ``frame`` on CUDA tensors, operands as K4's
    wrapper takes them, at ``formats`` ((len, ints) of a, of b, of the
    product); returns the products (written into ``out`` if given)."""
    a, a_stride, b = division_operands(a, b)
    if b.device.type != "cuda":
        raise ValueError(f"the steps run on the card and take CUDA tensors only, got {b.device}")
    out = torch.empty_like(b) if out is None else out
    with torch.cuda.device(b.device):
        err = _library()[1](FRAMES[frame], MUL_OPS[op], a.data_ptr(), b.data_ptr(),
                            out.data_ptr(), b.numel(), a_stride, *mul_step_args(*formats),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"multiply step ({frame}, {op}) failed to launch: error {err}")
    return out


def kernel_name(names, frame, op):
    """The one name in ``names`` (mangled kernel names) of multiply op
    ``op``'s kernel in frame ``frame``."""
    (name,) = [n for n in names if _FRAME_KERNEL[FRAMES[frame]] in n
               and _MUL_OP_TYPE[MUL_OPS[op]] in n]
    return name


def step_info(frame, op):
    """``{"registers", "spills", "sass_instructions", "sass_per_element"}``
    of a multiply step's kernel: ptxas's registers and spill line, the
    static SASS of its body up to its last exit, and that over the elements
    a thread takes.  For the row table, unrolled to 62 rows with an exit
    after each, the body is all 62."""
    log = (_build().parent / "nvcc.log").read_text()
    registers = sass.ptxas_registers(log)
    name = kernel_name(registers, frame, op)
    spills = [line for entry, line in sass.ptxas_spills(log).items() if entry == name]
    fns = sass.functions(sass.dump(_build()))
    body = sass.main_body(fns[kernel_name(fns, frame, op)])
    return {"registers": registers[name], "spills": spills[0] if spills else "",
            "sass_instructions": len(body),
            "sass_per_element": len(body) / _ELEMS_PER_THREAD[FRAMES[frame]]}


def _event_ms(fn, launches):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def _in_turns(runs, device, rounds, launches, warm_up_s):
    """``{label: median ms}`` of ``runs``, every one once a round, ``rounds``
    rounds of ``launches`` launches each, after ``warm_up_s`` seconds of
    launches."""
    samples = {label: [] for label in runs}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_up_s:
        for fn in runs.values():
            fn()
        torch.cuda.synchronize(device)
    for _ in range(rounds):
        for label, fn in runs.items():
            samples[label].append(_event_ms(fn, launches))
    return {label: statistics.median(v) for label, v in samples.items()}


def measure(device="cuda", elems=16_777_216, rounds=15, launches=10, seed=21, warm_up_s=1.0):
    """Rows ``{"step", "frame", "op", "shape", "ms", "bytes_per_element",
    "card_after"}``
    for every division step at both division shapes, and ``torch.div``
    (floor) as the last row of each, then every multiply step at the High
    dot product's format: the median of ``rounds`` CUDA-event timings of
    ``launches`` launches (the queue then hides the host's part of a
    launch), taken in turns (every step of a shape once, ``rounds`` times
    over) after ``warm_up_s`` seconds of launches, so that the card's clocks
    are up.  Raises if a division step's quotients differ from
    ``torch.div``'s anywhere, or a multiply step's products from the
    port's K4.  ``card_after`` is the card's clocks, power and temperature
    read right after a shape's timings."""
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
        ms = _in_turns(runs, device, rounds, launches, warm_up_s)
        after = card_state()
        for label, frame, op in STEPS + [("torch.div floor", None, None)]:
            rows.append({"step": label, "frame": frame, "op": op, "shape": shape,
                         "elements": elems, "ms": ms[label], "bytes_per_element": moved,
                         "card_after": after})
    del d, shapes
    a = torch.randint(0, 1 << 40, (elems,), dtype=torch.int64, device=device, generator=g)
    b = torch.randint(0, 1 << 40, (elems,), dtype=torch.int64, device=device, generator=g)
    (al, ai), (bl, bi), (nl, ni) = HIGH_MUL
    ref = batched_mul_window(a, b, al, ai, bl, bi, nl, ni)
    runs = {}
    for label, frame, op in MUL_STEPS:
        runs[label] = functools.partial(run_mul_step, frame, op, a, b, HIGH_MUL, out)
        assert torch.equal(runs[label](), ref), f"{label} differs from the port's K4"
    ms = _in_turns(runs, device, rounds, launches, warm_up_s)
    after = card_state()
    for label, frame, op in MUL_STEPS:
        rows.append({"step": label, "frame": frame, "op": op, "shape": "High multiply",
                     "elements": elems, "ms": ms[label], "bytes_per_element": 24,
                     "card_after": after, **step_info(frame, op)})
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
