#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds every kernel from the sources in ``matrix_inversion_tpu_torch/csrc``
(nvcc, sm_90a, one process per library, all at once): the fused
whole-inversion kernel K1, untracked and tracked, and the op-by-op path's
division kernels K2/K3 and windowed-multiply kernel K4.  Holds each against
its plain PyTorch version on the card bit for bit: K1 on eight untracked
configurations and five tracked ones on batches with overflowing matrices
(flags included), each through both of its layouts, the callers'
``(B, n*n)`` and cell-major, and at n = 3, 4, 5 on a ragged batch, one
matrix, a view 8 bytes off 16-byte alignment and a view that is not
contiguous; K2 and K3 at the High and Low divide and reciprocal
widths on floor-boundary inputs, zero divisors, a one-word dividend, an
unaligned view and odd lengths, and on the 16,777,216 timed elements; K4,
the truncated multiply in the streaming frame K2 and K3 share, at every
preset's multiply format (each a compile-time instance) and at formats
that take each of its word widths, with zeros and all-ones words, a
one-word multiplier, an unaligned view and an odd length, and on the
16,777,216 timed elements.  Then it drives the paths through
``BatchedMatrixInversion``: HIGH n=4 over 1,048,576 matrices, untracked
and with ``track_overflow=True`` (K1); HIGH n=16 over 262,144 matrices,
past K1's n <= 12, on the op-by-op path (K2 and K4), and that path on
4,113 matrices under ``set_division_impl("classic")`` (K3) and tracked;
and HIGH n=4 with ``lowering="unroll"`` (K2 and K4) against K1.  Digit I/O:
``BatchedMatrixInversion(io="digits")`` at HIGH n=4 over 262,144 matrices
(pack, K1 once, unpack) against the packed path and the CPU, and at n=16
(K2 and K4); ``EncryptedMatrixInversion`` one matrix at a time, digit and
packed io, untracked and tracked, ``run`` (K1) == ``run(simulate=True)``
(K2 and K4) == the CPU run; and ``qfloat_pivot``, ``qfloat_lu_L`` and
``qfloat_lu_U`` against the CPU.  Each path runs with the launch
counts set to 0 just before and read just after, and agrees with its plain
version on the card and on the CPU.  One ``run_raw`` of each n=4 main path
runs under the profiler and must show K1 and no other kernel or copy.
Times each kernel, ``run_raw`` and plain version with CUDA events; K2,
K3 and K4 at 16,777,216 elements and at a call's own 262,144; K1 and
the n=4 ``run_raw`` in turns beside what they replaced (the transposes
around the first kernel); the digit ``run_raw`` in turns with the packed one,
K1 alone, the pack and the unpack; the steps of K2's, K3's and K4's designs in turns
(``utils/division_steps.py``, K4's with registers, spills and static SASS)
and those of K1's, with registers, spills and static SASS
(``utils/fused_steps.py``).

Then the roofline path: the issue-rate probes K5 (``utils/ubench.py``,
built in the same parallel step) equal their plain version bit for bit on
all thirteen mixes, on a ragged input and at the width they are measured
at, are timed at three K values (nominal ops/s per mix, the two slopes,
the SASS instructions per nominal op), and their rates go into
``kernel_roofline`` with K1's histogram and K1's time from this run, for
HIGH n = 2..5, untracked and tracked.  A kernel's bound is the least work
known for its function (bytes, or instructions by the cheapest exact way
known) and must stay under every time measured for that function; what the
kernel's own code issues is printed beside it, for K2, K3 and K4 too.
Then the serving pipeline and the user's tools: the native marshaller
(``csrc/qmarshal.cc``, built with g++ in the same parallel step) against
the numpy route bit for bit on the main path's batch (packed) and at the
digit path's (digits); ``StreamingInverter`` at HIGH n=4 over 1,048,576
matrices a batch, packed (6 batches; 3 tracked) and digit I/O (3 batches of
262,144), every batch equal to ``inv.run`` and K1 launched once a batch; a
producer failure in the third batch raised after two results; the e2e
benchmark (``utils/run_benchmarks.py::e2e``: the device alone, and the native
and numpy routes, serial and streamed; its dict on one line); the CLI
(``python -m matrix_inversion_tpu_torch --sizes 2,3,5 --preset low``,
plain, ``--simulate`` and ``--batch 4``, in subprocesses); the reference's
10,000-inversion error sweep at LOW n=3, whose first batch equals the
CPU's; and ``run_qfloat_inverse``, ``compare_plu`` and ``debug_inverse`` on
one HIGH n=4 matrix against the CPU.

Any failure raises.  The last line is one JSON object naming
the device.  Imports nothing of JAX.
"""

import concurrent.futures
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from matrix_inversion_tpu_torch import (
    HIGH,
    LOW,
    MEDIUM,
    MEDIUM_PLUS,
    BatchedMatrixInversion,
    EncryptedMatrixInversion,
    float_matrix_to_qfloat_arrays,
    qfloat_lu_L,
    qfloat_lu_U,
    qfloat_matrix_inverse,
    qfloat_pivot,
    set_division_impl,
)
from matrix_inversion_tpu_torch.models.inverse import digit_output
from matrix_inversion_tpu_torch.models.marshal import (
    float_matrix_to_mags_and_signs,
    mags_and_signs_to_float_matrix,
    qfloat_and_signs_arrays_to_float_matrix,
)
from matrix_inversion_tpu_torch.ops import cuda_build, fused_inverse, long_division, packed
from matrix_inversion_tpu_torch.runtime import native
from matrix_inversion_tpu_torch.runtime.stream import StreamingInverter
from matrix_inversion_tpu_torch.utils import (
    debug,
    division_steps,
    fused_steps,
    precision,
    roofline,
    run_benchmarks,
    sass,
    ubench,
)
from matrix_inversion_tpu_torch.utils.profiling import device_trace
from matrix_inversion_tpu_torch.utils.timing import card_name_and_limit, card_state, timed_chain

MAIN_BATCH = 1_048_576
LARGE_N = 16
LARGE_BATCH = 262_144
DIGIT_BATCH = 262_144  # digit I/O: 1.34 GB of int64 digits in, 0.69 GB of int32 out
CHECK_BATCH = 4096 + 17  # ragged: not a multiple of the block size
REPS = 7
LARGE_REPS = 3  # the n=16 op-by-op run_raw takes seconds
KERNEL_ELEMS = 16_777_216
KERNEL_LAUNCHES = 10  # per timed pass of an op-by-op kernel: the queue hides the host's part
K1_LAUNCHES = 5  # per timed pass of K1 alone
K1_LAYOUT_NS = (3, 4, 5)  # the layout checks: n*n odd, a power of two, odd
HBM_BYTES_PER_S = 3.35e12  # published memory rate of the card
# K4's launches in one HIGH run_raw op by op, by n: one per untracked
# multiply of the circuit
K4_LAUNCHES = {4: 50, 16: 4840}
# K2's launches in one HIGH run_raw op by op, by n: one per division
K2_LAUNCHES = {4: 22, 16: 376}
# K2's and K4's launches in each of qfloat_lu_L and qfloat_lu_U at HIGH,
# by n: the LU half of the circuit
LU_LAUNCHES = {4: {"long_division_float": 6, "mul_window": 14}}

# The serving phase: the stream at the main path's batch (6 batches, 3
# tracked) and at the digit path's (3), the e2e benchmark at the main path's
# batch in 4 batches of 2 passes a leg (the JAX benchmark's defaults are 8 and
# 3: cut to keep the phase near a minute), the reference's 10,000-inversion
# sweep, whose first batch is held to the CPU, and the CLI at sizes 2, 3, 5:
# its default 2,3,5,10 would build K1 at LOW n=10, which takes nvcc minutes
# and was never checked against its plain version (ROADMAP R5).
SERVE_BATCHES = 6
SERVE_TRACKED_BATCHES = 3
SERVE_DIGIT_BATCHES = 3
E2E_BATCHES = 4
E2E_REPEATS = 2
STEADY_BATCHES = 16  # the stream once more, after a warm run, on the same batch
STAGE_PASSES = 3
PRECISION_N = 10_000
PRECISION_CHECK = 2048  # precision_benchmark's batch: its first call
CLI_SIZES = (2, 3, 5)
CLI_RUNS = ((), ("--simulate",), ("--batch", "4"))
CLI_TIMEOUT_S = 600

# The probes: rows of 128 elements, chains per element, the three K values
# whose two differences must agree (a cell primitive is hundreds of
# instructions, so the cell mixes take 16x shorter chains), and launches
# per timing pass.
UBENCH_ROWS = 8192
UBENCH_C = 8
UBENCH_KS = (256, 1024, 2048)
UBENCH_CELL_KS = (16, 64, 128)
UBENCH_REPS = 10
UBENCH_PASSES = 5
# chain lengths of the check at full width: 67 = 8 * 8 + 3 runs the unrolled
# K loop and its remainder; a cell mix's loop is not unrolled, and its plain
# version is hundreds of torch ops per iteration
UBENCH_CHECK_K = 67
UBENCH_CELL_CHECK_K = 9
SLOPES_AGREE_WITHIN = 0.10  # of the smaller slope; the passes spread by under 5%

# 32-bit instructions per element that the FUNCTION of each op-by-op kernel
# needs, by the cheapest exact way known (utils/roofline.py's table): K2 and
# K3 both compute a floor division, whatever their algorithms, and K4 a
# truncated multiply.  These give the bounds.
OP_KERNEL_FUNCTION = {
    "long_division_float": "divide",
    "long_division_classic": "divide",
    "mul_window": "mul",
}

# The kernels whose SASS gives each op-by-op kernel's issued instructions per
# element at the timed shapes, four elements a thread: K2's compile-time
# (60, 15) instance, K3, and K4's instance for the High dot product.
OP_SASS_KERNELS = {
    "long_division_float": ("long_division", "stream_kernelILi2EN7longdiv10FloatFixedILi60ELi15EEE"),
    "long_division_classic": ("long_division", "stream_kernelILi2EN7longdiv7ClassicEE"),
    "mul_window": ("mul_window", "stream_kernelILi2EN6mulwin10TruncFixedILi20ELi20ELi40EEE"),
}
OP_ELEMS_PER_THREAD = 4
# Opcodes that K3, an integer-only division, must not hold, and the 64-bit
# conversions that K2 must not hold.
FLOAT_OPCODES = re.compile(
    r"^(FADD|FMUL|FFMA|FMNMX|FSEL|FSET|FSETP|FCHK|FRND|MUFU|I2F|I2FP|F2I|F2IP|F2F"
    r"|DADD|DMUL|DFMA|DSETP|DMNMX|H[A-Z]+2)$")
WIDE_CONVERSION = re.compile(r"\b(I2F|I2FP|F2I|F2IP)\S*\.[US]64\b")

# Instructions that one iteration of one u32_kernelmix chain needs: of its 22
# nominal ops the two converts are free, (x - y) + (c - b) is two three-input
# adds, and the xor and the and of the last line are one logic op; nvcc finds
# no fewer (16.05 in its SASS with the loop's own).
UBENCH_KERNELMIX_INSTR = 16

# (label, n_bits, divisor_bits) of the divisions of the High and Low
# circuits: the true division (len + frac digits by len) and the
# reciprocal (1 + frac + len digits by len).
DIVISION_SHAPES = [
    ("HIGH divide", 60, 40),
    ("HIGH invert", 61, 40),
    ("LOW divide", 37, 23),
    ("LOW invert", 38, 23),
]

# ((len, ints) of a, of b, of the output) of the windowed multiply:
# tests/test_pallas.py:80-83 (the 128-bit product), the widened 2x2
# intermediate (C in 64 bits), the widening t1 <= 0, and the presets' own
# multiplies, each a compile-time instance of K4: High's dot product,
# Medium's and Medium+'s, Medium's by an integer-free operand (C in 64
# bits), Low's two.
MUL_FORMATS = [
    ((40, 16), (40, 16), (40, 16)),
    ((40, 16), (40, 0), (40, 16)),
    ((23, 9), (23, 9), (21, 21)),
    ((43, 40), (43, 40), (40, 0)),
    ((40, 20), (40, 20), (40, 20)),
    ((31, 16), (31, 16), (31, 16)),
    ((31, 16), (31, 0), (31, 16)),
    ((23, 9), (23, 9), (23, 9)),
    ((23, 9), (23, 0), (23, 9)),
]
HIGH_MUL = (40, 20, 40, 20, 40, 20)  # the High dot product's multiply, as the wrapper takes it

CHECKS = [
    ("HIGH n=2", HIGH.replace(n=2), False),
    ("HIGH n=3", HIGH.replace(n=3), False),
    ("HIGH n=4", HIGH.replace(n=4), False),
    ("HIGH n=5", HIGH.replace(n=5), False),
    ("LOW n=4", LOW.replace(n=4), False),
    ("MEDIUM n=3", MEDIUM.replace(n=3), False),
    ("MEDIUM_PLUS n=4", MEDIUM_PLUS.replace(n=4), False),
    ("LOW n=3 singular", LOW.replace(n=3), True),
]

TRACKED_CHECKS = [
    ("HIGH n=2", HIGH.replace(n=2)),
    ("HIGH n=3", HIGH.replace(n=3)),
    ("HIGH n=4", HIGH.replace(n=4)),
    ("HIGH n=5", HIGH.replace(n=5)),
    ("LOW n=4", LOW.replace(n=4)),
]


def config_of(p):
    return (p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)


def max_abs_diff(a, b):
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def overflowy(rng, B, n, rows):
    """Random x100 matrices; of the first ``2 * rows``, half near-singular
    (their inverses overflow the integer range), half all-zero (division by
    zero saturates), as tests/test_overflow.py::_overflowy_batch."""
    M = rng.randn(B, n, n) * 100
    M[:rows, 1] = M[:rows, 0] * (1 + 1e-12)
    M[rows:2 * rows] = 0.0
    return M


def ptxas_info(build_dir):
    """ptxas's kernel names and their register and spill lines for one
    built library."""
    log = (build_dir / "nvcc.log").read_text()
    return " | ".join(
        line.split("ptxas info    : ")[-1].strip()
        for line in log.splitlines()
        if "Used" in line or "spill" in line or "entry function" in line
    )


def timed_ms(fn, dev, passes=REPS, warm_up=True, launches=1):
    """Median milliseconds of one call over ``passes`` timed passes of
    ``launches`` calls each (CUDA events on the card), after a warm-up call."""
    if warm_up:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return timed_chain(lambda s: fn(), lambda s: None, None, launches, passes,
                       device=dev)[0] * 1e3 / launches


def replay_of(launch, count):
    """The replay of a CUDA graph of ``count`` calls of ``launch``, which
    launches on the current stream, allocates nothing and returns a
    cudaError_t: the kernels' device time without the host's part of a
    launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert launch() == 0, "a launch failed before capture"
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        errors = [launch() for _ in range(count)]
    assert not any(errors), f"launches failed in capture: {errors}"
    return graph.replay


def reset_counts():
    fused_inverse.LAUNCHES = fused_inverse.TRACKED_LAUNCHES = 0
    for name in long_division.LAUNCHES:
        long_division.LAUNCHES[name] = 0


def counts():
    return {"fused_inverse": fused_inverse.LAUNCHES,
            "fused_inverse_tracked": fused_inverse.TRACKED_LAUNCHES,
            **long_division.LAUNCHES}


def timed_s(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def timed_in_turns(fns, dev, rounds=REPS, launches=1):
    """``{label: median ms of one call}`` of the functions ``fns``, each
    timed once per round (``launches`` calls between two events), ``rounds``
    rounds, after one warm-up call each: two versions timed so see the same
    clocks."""
    for fn in fns.values():
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    samples = {label: [] for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            samples[label].append(timed_ms(fn, dev, passes=1, warm_up=False, launches=launches))
    return {label: statistics.median(v) for label, v in samples.items()}


def k1_both_layouts(m, s, config, track):
    """K1 on ``(B, n*n)`` tensors through its two layouts: as they lie, and
    transposed to cell-major and back; two tuples of outputs."""
    rows = fused_inverse.fused_matrix_inverse(m, s, *config, track=track)
    cm = fused_inverse.fused_inverse_cell_major(
        m.t().contiguous(), s.t().contiguous(), *config, track=track)
    return rows, (cm[0].t(), cm[1].t(), *cm[2:])


def check_k1(dev, label, p, M, track):
    """K1 == the plain version, tolerance 0, through both layouts (flags
    included when tracked); returns the max error and the (B, n*n) outputs."""
    m, s = float_matrix_to_mags_and_signs(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    m, s = torch.from_numpy(m).to(dev), torch.from_numpy(s).to(dev)
    config = config_of(p)
    ref = fused_inverse.fused_matrix_inverse_reference(m, s, *config, track=track)
    rows, cell_major = k1_both_layouts(m, s, config, track)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = max(max_abs_diff(rows, ref), max_abs_diff(cell_major, ref))
    assert err == 0, f"{label}: kernel differs from the plain version (max {err})"
    return err, rows


def check_k1_layouts(dev, batch=CHECK_BATCH + 37):
    """K1 == the plain version, tolerance 0, untracked and tracked, HIGH
    n = 3, 4, 5, on what a caller's ``(B, n*n)`` tensors may be: a ragged
    batch, one matrix, a view that starts 8 bytes off 16-byte alignment and
    a view that is not contiguous; every case through both layouts.
    Returns the max error of each variant."""
    worst = {False: 0, True: 0}
    for n in K1_LAYOUT_NS:
        p = HIGH.replace(n=n)
        config, n2 = config_of(p), n * n
        M = overflowy(np.random.RandomState(600 + n), batch, n, rows=1)
        m, s = float_matrix_to_mags_and_signs(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
        m, s = torch.from_numpy(m).to(dev), torch.from_numpy(s).to(dev)

        def off_alignment(x):
            flat = torch.empty(x.numel() + 3, dtype=x.dtype, device=dev)
            start = 1 if flat.data_ptr() % 16 == 0 else 2
            view = flat[start:start + x.numel()].view(x.shape)
            view.copy_(x)
            assert view.data_ptr() % 16 == 8 and view.is_contiguous()
            return view

        def strided(x):
            view = torch.cat([x, x + 1], dim=1)[:, :n2]
            assert not view.is_contiguous()
            return view

        cases = {
            f"ragged B={batch}": (m, s, batch),
            "B=1": (m[:1], s[:1], 1),
            "8 bytes off 16-byte alignment": (off_alignment(m), off_alignment(s), batch),
            "not contiguous": (strided(m), strided(s), batch),
        }
        for track in (False, True):
            ref = fused_inverse.fused_matrix_inverse_reference(m, s, *config, track=track)
            for what, (cm, cs, count) in cases.items():
                for got in k1_both_layouts(cm, cs, config, track):
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err = max_abs_diff(got, [r[:count] for r in ref])
                    worst[track] = max(worst[track], err)
                    assert err == 0, (f"K1 HIGH n={n} track={track}, {what}: differs from the "
                                      f"plain version (max {err})")
            if track:
                assert int(ref[2][0]) == 1 and int(ref[2][1]) == 1 and not bool(ref[2].all())
        print(f"check K1 layouts HIGH n={n}: {', '.join(cases)}; untracked and tracked, through "
              "(B, n*n) and cell-major: kernel == plain version bit for bit (tolerance 0 on "
              "magnitudes, signs and flags)")
    return worst


def kernels_by_step(dev, steps):
    """``{label: {kernel name: launches}}`` of the device work of each
    function in ``steps``, from one profiler trace (``device_trace``): each
    step runs, and is synchronized, inside a labelled range, and a kernel,
    copy or fill belongs to the range its start falls in.  Raises if some
    device work falls in no range."""
    with tempfile.TemporaryDirectory() as logdir:
        with device_trace(logdir) as prof:
            for label, fn in steps.items():
                with torch.profiler.record_function(f"step:{label}"):
                    fn()
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
    events = list(prof.events())
    ranges = {e.name[5:]: e.time_range for e in events if e.name.startswith("step:")}
    assert set(ranges) == set(steps), f"the trace holds the ranges {list(ranges)}"
    ran = {label: {} for label in steps}
    for e in events:
        # the ranges themselves come back as device-side annotations too
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("step:"):
            continue
        owners = [label for label, r in ranges.items() if r.start <= e.time_range.start <= r.end]
        assert len(owners) == 1, f"device work {e.name} lies in the ranges {owners}"
        ran[owners[0]][e.name] = ran[owners[0]].get(e.name, 0) + 1
    return ran


def check_launches_under_profiler(dev, inv, mags, signs, tinv, tmags, tsigns,
                                  batch=LARGE_BATCH):
    """One trace over one ``run_raw`` of each n=4 main path and one
    ``PackedQFloat.invert`` as the High circuit calls it (61 bits by 40).
    Each ``run_raw`` must run K1 once and nothing else on the device: no
    transpose, no copy, no fill.  The reciprocal must launch the division
    kernel once and no fill for its dividend (one cached word, read from
    its address)."""
    x = packed.PackedQFloat(
        torch.randint(1, 1 << 40, (batch,), dtype=torch.int64, device=dev), 40, 20)
    x.invert(1, 40, 0)  # the constant word is filled once, here at the latest
    inv.run_raw(mags, signs)
    tinv.run_raw(tmags, tsigns)
    before = long_division.LAUNCHES["long_division_float"]
    got = []
    ran = kernels_by_step(dev, {
        "main path": lambda: inv.run_raw(mags, signs),
        "tracked main path": lambda: tinv.run_raw(tmags, tsigns),
        "reciprocal": lambda: got.append(x.invert(1, 40, 0)),
    })
    for label in ("main path", "tracked main path"):
        k1 = [name for name in ran[label] if "fused_inverse_kernel" in name]
        assert dev.type != "cuda" or (len(k1) == 1 and ran[label][k1[0]] == 1), \
            f"{label}: the profiler saw K1 {[(n, ran[label][n]) for n in k1]}"
        others = [name for name in ran[label] if name not in k1]
        assert not others, f"{label}: run_raw put more than K1 on the device: {others}"
        print(f"{label}: one run_raw under the profiler ran {ran[label]}: K1 once, no "
              "transpose, no copy")
    ref = packed.packed_long_division_reference(
        torch.tensor(1 << 60, device=dev), x.mag, 61) & ((1 << 40) - 1)
    assert torch.equal(got[0].mag, ref), "invert differs from the plain version"
    assert long_division.LAUNCHES["long_division_float"] == before + 1
    names = ran["reciprocal"]
    division = [n for n in names if "stream_kernel" in n]
    assert dev.type != "cuda" or (len(division) == 1 and names[division[0]] == 1), \
        f"the profiler saw the division kernels {division} in {names}"
    fills = [n for n in names if "fill" in n.lower()]
    assert not fills, f"a reciprocal launched a fill: {fills}"
    print(f"reciprocal: invert of {batch} High values launched {names}: one division kernel, "
          "no fill for the dividend")


def division_inputs(rng, n_bits, divisor_bits, dev):
    """CHECK_BATCH random dividends and divisors, the fixup-boundary set
    of tests/test_pair_qfloat.py:211-250 (v = q*d, q*d - 1, q*d + d - 1),
    zero divisors, the widest divisor and the widest dividend."""
    vmax, dmax = (1 << n_bits) - 1, (1 << divisor_bits) - 1
    vs = (rng.randint(0, 1 << 62, size=CHECK_BATCH, dtype=np.int64) & vmax).tolist()
    ds = (rng.randint(0, 1 << 62, size=CHECK_BATCH, dtype=np.int64) & dmax).tolist()
    for _ in range(2048):
        d = min(int(rng.randint(1, 1 << 31)) * int(rng.randint(1, 1 << 9)) + 1, dmax)
        d >>= int(rng.randint(0, 24))
        q = int(rng.randint(0, 1 << 20)) << int(rng.randint(0, 40))
        for v in (q * d, q * d - 1, q * d + d - 1):
            if 0 <= v <= vmax and d > 0:
                vs.append(v)
                ds.append(d)
    vs += [vmax, vmax, vmax, 0, 12345]
    ds += [1, dmax, dmax - 1, 0, 0]
    return (torch.tensor(vs, dtype=torch.int64, device=dev),
            torch.tensor(ds, dtype=torch.int64, device=dev))


def check_division_kernels(dev):
    """K2 and K3 == the plain version, tolerance 0, on arrays, on a one-word
    dividend, on views that are 8- but not 16-byte aligned and on odd
    lengths; returns each kernel's max error."""
    max_err = {"long_division_float": 0, "long_division_classic": 0}
    for i, (label, n_bits, divisor_bits) in enumerate(DIVISION_SHAPES):
        v, d = division_inputs(np.random.RandomState(300 + i), n_bits, divisor_bits, dev)
        k = packed._float_div_chunk_bits(n_bits, divisor_bits)
        one = torch.tensor(1 << (n_bits - 1), dtype=torch.int64, device=dev)
        odd = v.numel() - 1 + v.numel() % 2
        # (dividend, divisor): whole arrays; a 0-dim dividend, read from its one
        # address; both operands off 16-byte alignment; the divisor alone; an odd
        # length; a one-element array as the dividend
        cases = [(v, d), (one, d), (v[1:], d[1:]), (v[:-1], d[1:]), (v[:odd], d[:odd]),
                 (v[3:4], d[:5])]
        assert v[1:].data_ptr() % 16 == 8 and odd % 2 == 1
        runs = [("long_division_float k=%d" % k,
                 lambda x, y: long_division.batched_long_division_float(x, y, n_bits, k))]
        for bits in (1, 2):
            if n_bits % bits == 0:
                runs.append((f"long_division_classic bits={bits}",
                             lambda x, y, b=bits: long_division.batched_long_division(
                                 x, y, n_bits // b, b)))
        for name, run in runs:
            err = 0
            for x, y in cases:
                got, ref = run(x, y), packed.packed_long_division_reference(x, y, n_bits)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                assert got.shape == ref.shape == y.shape
                err = max(err, max_abs_diff([got], [ref]))
            kernel = name.split()[0]
            max_err[kernel] = max(max_err[kernel], err)
            assert err == 0, f"{name} {label}: kernel differs from the plain version (max {err})"
            print(f"check {name} {label} (n_bits {n_bits}, divisor < 2**{divisor_bits}): "
                  f"{v.numel()} values incl. floor boundaries and zero divisors; a 0-dim and a "
                  "one-element dividend; views off 16-byte alignment; an odd length; kernel == "
                  "plain version bit for bit (tolerance 0)")
    return max_err


def check_mul_kernel(dev):
    """K4 == the plain version, tolerance 0, at every format of MUL_FORMATS
    on random operands with zeros and all-ones words among them, on a 0-dim
    and a one-element multiplier, on views that are 8- but not 16-byte
    aligned and on an odd length; returns the max error."""
    max_err = 0
    for i, ((al, ai), (bl, bi), (nl, ni)) in enumerate(MUL_FORMATS):
        rng = np.random.RandomState(400 + i)
        a = rng.randint(0, 1 << 62, size=CHECK_BATCH, dtype=np.int64) & ((1 << al) - 1)
        b = rng.randint(0, 1 << 62, size=CHECK_BATCH, dtype=np.int64) & ((1 << bl) - 1)
        a[:2], b[2:4], a[4:6], b[4] = 0, (1 << bl) - 1, (1 << al) - 1, 0
        a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        odd = a.numel() - 1 + a.numel() % 2
        cases = [(a, b), (a[5], b), (a[1:], b[1:]), (a[:-1], b[1:]), (a[:odd], b[:odd]),
                 (a[3:4], b[:5])]
        assert a[1:].data_ptr() % 16 == 8 and odd % 2 == 1
        err = 0
        for x, y in cases:
            got = long_division.batched_mul_window(x, y, al, ai, bl, bi, nl, ni)
            ref = packed.mul_window_packed(x.expand_as(y), al, ai, y, bl, bi, nl, ni, 1)[0]
            if dev.type == "cuda":
                torch.cuda.synchronize()
            assert got.shape == ref.shape == y.shape
            err = max(err, max_abs_diff([got], [ref]))
        max_err = max(max_err, err)
        assert err == 0, f"mul_window {(al, ai)}x{(bl, bi)}->{(nl, ni)}: kernel differs (max {err})"
        print(f"check mul_window (len, ints) {(al, ai)} x {(bl, bi)} -> {(nl, ni)} (t1, nt, "
              f"newlength {long_division.mul_trunc_format(al, ai, bl, bi, nl, ni)}): "
              f"B={CHECK_BATCH} with zeros and all-ones words; a 0-dim and a one-element "
              "multiplier; views off 16-byte alignment; an odd length; kernel == plain version "
              "bit for bit (tolerance 0)")
    return max_err


def large_n_matrices(rng, B, n):
    """The first 64 well conditioned (randn*10 + 20*I, as
    tests/test_lu_scan.py:95) for the error check, the rest random x100."""
    M = rng.randn(B, n, n) * 100
    M[:64] = rng.randn(64, n, n) * 10 + 20 * np.eye(n)
    return M


def with_sign0_cells(signs, seed):
    """Sign 0 on about 5% of the cells past the first 64 matrices."""
    mask = torch.from_numpy(np.random.RandomState(seed).rand(*signs.shape) < 0.05)
    mask[:64] = False
    return torch.where(mask.to(signs.device), 0, signs)


def large_n_paths(dev, card, batch=LARGE_BATCH, check_batch=CHECK_BATCH, reps=LARGE_REPS):
    """The op-by-op path past K1's n <= 12: HIGH n=16 through
    BatchedMatrixInversion (K2 and K4), then the same path under the
    classic division (K3) and tracked, and HIGH n=4 op by op against K1;
    times the n=16 run_raw against its plain version.  Returns each
    op-by-op kernel's launch count on its own path."""
    p = HIGH.replace(n=LARGE_N)
    config = config_of(p)
    inv = BatchedMatrixInversion(p, batch, io="packed", device=dev)
    M = large_n_matrices(np.random.RandomState(16), batch, LARGE_N)
    mags, signs = inv.quantize(M)
    signs = with_sign0_cells(signs, 17)
    reset_counts()
    out = inv.run_raw(mags, signs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    main_counts = counts()
    assert main_counts["long_division_float"] > 0, "the n=16 path did not launch K2"
    assert main_counts["mul_window"] == K4_LAUNCHES[LARGE_N], \
        f"the n=16 path launched K4 {main_counts['mul_window']} times"
    assert main_counts["fused_inverse"] == main_counts["fused_inverse_tracked"] == 0, \
        "the n=16 path launched K1"
    assert main_counts["long_division_classic"] == 0
    res = inv.dequantize(out)
    assert out[0].shape == (batch, LARGE_N ** 2) and res.shape == (batch, LARGE_N, LARGE_N)
    assert np.isfinite(res).all()
    ref = fused_inverse.fused_matrix_inverse_reference(mags, signs, *config)
    err = max_abs_diff(out, ref)
    assert err == 0, f"n=16 path differs from the plain version on the card (max {err})"
    cpu = fused_inverse.fused_matrix_inverse_reference(mags[:64].cpu(), signs[:64].cpu(), *config)
    assert all(torch.equal(o[:64].cpu(), c) for o, c in zip(out, cpu)), \
        "n=16 path differs from the CPU plain path"
    mae = float(np.mean(np.abs(res[:64] - np.linalg.inv(M[:64]))))
    assert mae < 1e-2, f"n=16: mean absolute error {mae} against np.linalg.inv"
    print(f"large-n path: HIGH n={LARGE_N} B={batch}: launches {main_counts}; == plain "
          "version on the card (all) and on the CPU (first 64); mean abs error vs "
          f"np.linalg.inv on 64 well-conditioned matrices {mae:.3e}")

    # the same path on a check batch with the classic division (K3)
    cinv = BatchedMatrixInversion(p, check_batch, io="packed", device=dev)
    with set_division_impl("classic"):
        reset_counts()
        got = cinv.run_raw(mags[:check_batch], signs[:check_batch])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        classic_counts = counts()
    assert classic_counts["long_division_classic"] > 0, "classic division: K3 not launched"
    assert classic_counts["long_division_float"] == 0
    assert all(torch.equal(g, o[:check_batch]) for g, o in zip(got, out)), \
        "n=16 under the classic division differs from the default"
    print(f"large-n path under classic division: B={check_batch}: launches {classic_counts}; "
          "== the default path bit for bit")

    tinv = BatchedMatrixInversion(p, check_batch, io="packed", device=dev,
                                  track_overflow=True)
    TM = overflowy(np.random.RandomState(18), check_batch, LARGE_N, rows=1)
    tm, ts = tinv.quantize(TM)
    reset_counts()
    tout = tinv.run_raw(tm, ts)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tracked_counts = counts()
    assert tracked_counts["long_division_float"] > 0 and tracked_counts["fused_inverse_tracked"] == 0
    assert tracked_counts["mul_window"] == 0, "a tracked multiply launched K4"
    tref = fused_inverse.fused_matrix_inverse_reference(tm, ts, *config, track=True)
    err = max_abs_diff(tout, tref)
    assert err == 0, f"tracked n=16 path differs from the tracked plain version (max {err})"
    flagged = int(tout[2].sum())
    assert tout[2].dtype == torch.int32 and 0 < flagged < check_batch
    assert int(tout[2][0]) == 1 and int(tout[2][1]) == 1
    print(f"tracked large-n path: HIGH n={LARGE_N} B={check_batch}: launches {tracked_counts}; "
          f"{flagged} flagged; == tracked plain version bit for bit, flags included")

    # HIGH n=4 op by op (K2, K4) against K1 on the same matrices
    p4 = HIGH.replace(n=4)
    uinv = BatchedMatrixInversion(p4.replace(lowering="unroll"), check_batch, io="packed",
                                  device=dev)
    um, us = uinv.quantize(np.random.RandomState(19).randn(check_batch, 4, 4) * 100)
    us = with_sign0_cells(us, 20)
    reset_counts()
    uout = uinv.run_raw(um, us)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    unroll_counts = counts()
    assert unroll_counts["long_division_float"] == K2_LAUNCHES[4], \
        f"HIGH n=4 op by op launched K2 {unroll_counts['long_division_float']} times"
    assert unroll_counts["mul_window"] == K4_LAUNCHES[4], \
        f"HIGH n=4 op by op launched K4 {unroll_counts['mul_window']} times"
    assert unroll_counts["fused_inverse"] == 0
    k1 = fused_inverse.fused_matrix_inverse(um, us, *config_of(p4))
    assert all(torch.equal(a, b) for a, b in zip(uout, k1)), "HIGH n=4: op-by-op path != K1"
    print(f"cross-check HIGH n=4 B={check_batch}: lowering=\"unroll\" (launches "
          f"{unroll_counts}) == K1 bit for bit")

    # run_raw with the kernels and inside plain_arithmetic(), in turns
    # (kernels first, then plain first, ...) after the warm checked runs
    def with_kernels():
        return timed_ms(lambda: inv.run_raw(mags, signs), dev, passes=1, warm_up=False)

    def plain():
        with packed.plain_arithmetic():
            return with_kernels()

    runs = {with_kernels: [], plain: []}
    for i in range(reps):
        for fn in (with_kernels, plain) if i % 2 == 0 else (plain, with_kernels):
            runs[fn].append(fn())
    for label, samples in (("with K2 and K4", runs[with_kernels]),
                           ("plain version (plain_arithmetic)", runs[plain])):
        ms = statistics.median(samples)
        print(f"time n={LARGE_N} run_raw {label}: median {ms:.3f} ms of "
              f"{[round(t, 3) for t in samples]} = {batch / ms * 1e3:.4e} inversions/s "
              f"(HIGH n={LARGE_N}, B={batch}; {card})")
    return {
        "long_division_float": main_counts["long_division_float"],
        "long_division_classic": classic_counts["long_division_classic"],
        "mul_window": main_counts["mul_window"],
    }


def expect_launches(label, got, **want):
    """Raise unless every kernel's launch count in ``got`` (``counts()``) is
    the one in ``want``, 0 where ``want`` names none."""
    for name, count in got.items():
        expected = want.get(name, 0)
        assert count == expected, f"{label}: launched {name} {count} times, expected " \
            f"{expected}: {got}"


def launches_of(fn):
    """``(fn(), counts())`` with the launch counts set to 0 just before the
    call and read just after it has finished on the card."""
    reset_counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, counts()


def digit_paths(dev, card, batch=DIGIT_BATCH, check_batch=CHECK_BATCH, large_n=LARGE_N):
    """Digit I/O on the card: ``BatchedMatrixInversion(io="digits")`` at HIGH
    n=4 (pack, K1 once, unpack) against the packed path on the same
    matrices and, on a check batch, against the CPU; at HIGH n=16 on a check
    batch (K2 and K4, as the packed path); ``EncryptedMatrixInversion`` at
    HIGH's format, n=4, one matrix at a time, digit and packed io, untracked
    and tracked, whose ``run``, ``run(simulate=True)`` (op by op: K2 and K4)
    and CPU run agree bit for bit; and the partial circuits against the CPU.
    Times the digit ``run_raw``, the packed ``run_raw``, K1 alone and the
    pack and unpack in turns."""
    p = HIGH.replace(n=4)
    config, L = config_of(p), p.qfloat_len
    inv = BatchedMatrixInversion(p, batch, io="digits", device=dev)
    M = np.random.RandomState(40).randn(batch, 4, 4) * 100
    t0 = time.perf_counter()
    d, s = inv.quantize(M)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    out, got = launches_of(lambda: inv.run_raw(d, s))
    expect_launches("digit path HIGH n=4", got, fused_inverse=1)
    t0 = time.perf_counter()
    res = inv.dequantize(out)
    dequantize_s = time.perf_counter() - t0
    assert d.shape == (batch, 16, L) and d.dtype == torch.int64 and s.shape == (batch, 16)
    assert out.shape == (batch, 16, L + 1) and out.dtype == torch.int32
    assert res.shape == (batch, 4, 4) and np.isfinite(res).all()
    pinv = BatchedMatrixInversion(p, batch, io="packed", device=dev)
    pm, ps = pinv.quantize(M)
    assert torch.equal(packed.digits_to_mags(d, 1), pm) and torch.equal(s, ps), \
        "digit and packed quantize disagree"
    pout = pinv.run_raw(pm, ps)
    assert torch.equal(packed.mags_to_digits(pout[0], L, 1), out[..., :L]) and \
        torch.equal(pout[1].to(torch.int32), out[..., L]), "digit path != packed path"
    cpu = qfloat_matrix_inverse(d[:check_batch].cpu(), s[:check_batch].cpu(), *config,
                                backend="packed")
    assert torch.equal(out[:check_batch].cpu(), cpu), "digit path differs from the CPU"
    mae = float(np.mean(np.abs(res[:64] - np.linalg.inv(M[:64]))))
    assert mae < 1e-3, f"digit path: mean absolute error {mae} against np.linalg.inv"
    print(f"digit path: HIGH n=4 B={batch} io=\"digits\": launches {got}; unpacked == the "
          f"packed path (all); == the CPU plain path (first {check_batch}); mean abs error vs "
          f"np.linalg.inv on 64 matrices {mae:.3e}")
    print(f"host clock, one pass, digit I/O: quantize + H2D {quantize_s:.3f} s "
          f"({d.numel() * 8 + s.numel() * 8} B), D2H + dequantize {dequantize_s:.3f} s "
          f"({out.numel() * 4} B) (HIGH n=4, B={batch}; {card})")

    # in turns: the digit run_raw, the packed run_raw, K1 alone, the pack
    # and the unpack, one call a pass and K1_LAUNCHES calls a pass
    fns = {
        "digit run_raw": lambda: inv.run_raw(d, s),
        "packed run_raw": lambda: pinv.run_raw(pm, ps),
        "K1 (B, n*n)": lambda: fused_inverse.fused_matrix_inverse(pm, ps, *config),
        "pack (digits_to_mags)": lambda: packed.digits_to_mags(d, 1),
        "unpack (digit_output)": lambda: digit_output(pout[0], pout[1], L, 2),
    }
    for calls in (1, K1_LAUNCHES):
        turns = timed_in_turns(fns, dev, launches=calls)
        for label, ms in turns.items():
            print(f"time digit I/O {label}, {calls} call(s) a pass: {ms:.3f} ms = "
                  f"{batch / ms * 1e3:.4e} inversions/s (HIGH n=4, B={batch}; {card})")
        print(f"digit / packed run_raw ({calls} call(s) a pass): "
              f"{turns['digit run_raw'] / turns['packed run_raw']:.2f}x; digit run_raw / K1: "
              f"{turns['digit run_raw'] / turns['K1 (B, n*n)']:.2f}x ({card})")
    del inv, d, s, out, pinv, pm, ps, pout

    # HIGH n=16 on a check batch: the op-by-op path between the pack and unpack
    p16 = HIGH.replace(n=large_n)
    M16 = large_n_matrices(np.random.RandomState(41), check_batch, large_n)
    dinv = BatchedMatrixInversion(p16, check_batch, io="digits", device=dev)
    d16, s16 = dinv.quantize(M16)
    out16, got16 = launches_of(lambda: dinv.run_raw(d16, s16))
    pinv16 = BatchedMatrixInversion(p16, check_batch, io="packed", device=dev)
    pout16, pgot16 = launches_of(lambda: pinv16.run_raw(*pinv16.quantize(M16)))
    for label, c in (("digit path", got16), ("packed path", pgot16)):
        expect_launches(f"{label} HIGH n={large_n}", c, long_division_float=K2_LAUNCHES[large_n],
                        mul_window=K4_LAUNCHES[large_n])
    assert torch.equal(digit_output(pout16[0], pout16[1], p16.qfloat_len, 2), out16), \
        f"digit path HIGH n={large_n} != packed path"
    print(f"digit path HIGH n={large_n} B={check_batch}: launches {got16} (packed path "
          f"{pgot16}); == the packed path bit for bit")

    # EncryptedMatrixInversion at HIGH's format, n=4, one matrix (batch shape ())
    rng = np.random.RandomState(42)
    matrices = [rng.randn(4, 4) * 100 for _ in range(4)] + [overflowy(rng, 1, 4, 1)[0]]
    kw = dict(qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints, true_division=True)
    for io, track in (("digits", False), ("packed", False), ("packed", True)):
        card_inv = EncryptedMatrixInversion(4, **kw, io=io, track_overflow=track, device=dev)
        cpu_inv = EncryptedMatrixInversion(4, **kw, io=io, track_overflow=track, device="cpu")
        k1 = {"fused_inverse_tracked" if track else "fused_inverse": 1}
        flags = []
        for i, A in enumerate(matrices):
            run, run_counts = launches_of(lambda: card_inv.run(A))
            sim, sim_counts = launches_of(lambda: card_inv.run(A, simulate=True))
            expect_launches(f"EncryptedMatrixInversion io={io} track={track} run", run_counts,
                            **k1)
            expect_launches(f"EncryptedMatrixInversion io={io} track={track} simulate",
                            sim_counts, long_division_float=K2_LAUNCHES[4],
                            mul_window=0 if track else K4_LAUNCHES[4])
            want = cpu_inv.run(A)
            for got_out in (run, sim):
                if track:
                    assert got_out[1] == want[1], f"io={io} tracked: flag {got_out[1]} != {want[1]}"
                    got_out, want_out = got_out[0], want[0]
                else:
                    want_out = want
                assert np.array_equal(got_out, want_out), \
                    f"EncryptedMatrixInversion io={io} track={track} matrix {i} != the CPU run"
            if track:
                flags.append(run[1])
            if i == 0:
                print(f"EncryptedMatrixInversion(4, HIGH's format, io={io!r}, "
                      f"track_overflow={track}) on the card: run launches {run_counts}; "
                      f"run(simulate=True) launches {sim_counts}")
        assert not track or flags == [0, 0, 0, 0, 1], f"tracked flags {flags}"
        print(f"EncryptedMatrixInversion io={io!r} track_overflow={track}: {len(matrices)} "
              "matrices, one overflowing: run == run(simulate=True) == the CPU run bit for bit"
              + (f", flags {flags}" if track else ""))

    # the partial circuits at HIGH n=4 on a check batch
    Mp = np.random.RandomState(43).randn(check_batch, 4, 4) * 100
    dp, sp = (torch.from_numpy(a) for a in float_matrix_to_qfloat_arrays(
        Mp, p.qfloat_len, p.qfloat_ints, p.qfloat_base))
    dpc, spc = dp.to(dev), sp.to(dev)
    for fn, want in ((qfloat_pivot, {}),
                     (qfloat_lu_L, LU_LAUNCHES[4]),
                     (qfloat_lu_U, LU_LAUNCHES[4])):
        got_p, got_counts = launches_of(lambda: fn(dpc, spc, p.as_list(), "packed"))
        expect_launches(fn.__name__, got_counts, **want)
        assert torch.equal(got_p.cpu(), fn(dp, sp, p.as_list(), "packed")), \
            f"{fn.__name__} on the card differs from the CPU"
        print(f"{fn.__name__} HIGH n=4 B={check_batch}: launches {got_counts}; == the CPU run "
              "bit for bit")


def both_routes(fn):
    """``(native result, numpy result, native s, numpy s)`` of ``fn()``, run
    once through the native marshaller and once with it switched off."""
    t0 = time.perf_counter()
    a = fn()
    native_s = time.perf_counter() - t0
    saved, native._LIB = native._LIB, False
    try:
        t0 = time.perf_counter()
        b = fn()
        numpy_s = time.perf_counter() - t0
    finally:
        native._LIB = saved
    return a, b, native_s, numpy_s


def same_arrays(a, b):
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def streamed(label, inv, batches, expected, card):
    """Drive ``StreamingInverter(inv)`` over ``batches`` with the launch
    counts set to 0 just before and read just after; raise unless every
    yielded batch equals ``inv.run`` of it bit for bit and the kernel named
    in ``expected`` ran once per batch.  Returns the results."""
    reset_counts()
    t0 = time.perf_counter()
    results = list(StreamingInverter(inv, depth=2, finish_workers=2).run(batches))
    if inv.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    expect_launches(f"stream {label}", got, **{expected: len(batches)})
    assert len(results) == len(batches)
    for k, (M, r) in enumerate(zip(batches, results)):
        assert same_arrays(r, inv.run(M)), f"stream {label}: batch {k} != inv.run"
    matrices = len(batches) * inv.batch_size
    print(f"stream {label}: {len(batches)} batches of {inv.batch_size}, depth 2, 2 finish "
          f"workers: launches {got}; every batch == inv.run bit for bit; host clock "
          f"{seconds:.3f} s = {matrices / seconds:.4e} inversions/s, first batch's pinned "
          f"allocations included ({card})")
    return results


def stream_stages(card, inv, M, passes=STAGE_PASSES, steady=STEADY_BATCHES):
    """Host-clock seconds of each stage of one streamed packed batch, alone
    (median of ``passes``): quantize into pinned buffers and into new
    arrays, the pinned H2D copy, ``run_raw``, the D2H copy into pinned
    memory, dequantize; then the stream over ``steady`` copies of ``M``
    after a warm run (its pinned buffers come from the caching allocator)."""
    dev = inv.device

    def seconds(fn):
        samples = []
        for _ in range(passes):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        return statistics.median(samples)

    t0 = time.perf_counter()
    ring = tuple(torch.empty(s, dtype=torch.int64, pin_memory=True) for s in inv.input_shapes())
    alloc_s = time.perf_counter() - t0
    ring_np = tuple(h.numpy() for h in ring)
    stages = {"quantize into pinned": lambda: inv._host_quantize(M, out=ring_np),
              "quantize into new arrays": lambda: inv._host_quantize(M)}
    args = tuple(h.to(dev) for h in ring)
    stages["H2D, pinned"] = lambda: [h.to(dev, non_blocking=True) for h in ring]
    out = inv.run_raw(*args)
    stages["run_raw"] = lambda: inv.run_raw(*args)
    pinned_out = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in out)
    stages["D2H, into pinned"] = lambda: [h.copy_(o, non_blocking=True)
                                          for h, o in zip(pinned_out, out)]
    host_out = tuple(h.numpy() for h in pinned_out)
    stages["dequantize"] = lambda: inv._host_dequantize(host_out)
    timed = {label: seconds(fn) for label, fn in stages.items()}
    list(StreamingInverter(inv).run([M] * 2))  # warm: the pinned pool holds the ring
    t0 = time.perf_counter()
    count = sum(r.shape[0] for r in StreamingInverter(inv).run([M] * steady))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    assert count == steady * inv.batch_size
    print(f"stream stages, HIGH n=4 packed, B={inv.batch_size}, host clock, median of {passes} "
          f"(s): pinned allocation of one input slot {alloc_s:.4f} (first use); "
          + ", ".join(f"{label} {s:.4f}" for label, s in timed.items())
          + f"; the stream over {steady} batches after a warm run: {stream_s:.3f} s = "
          f"{stream_s / steady:.4f} s a batch = {count / stream_s:.4e} inversions/s "
          f"({os.cpu_count()} host cores; {card})")


def run_cli(flags):
    """``python -m matrix_inversion_tpu_torch`` at CLI_SIZES, LOW preset, on
    the card: started, and a function that waits for it (killing it past
    the time limit) and returns its standard output."""
    cmd = [sys.executable, "-m", "matrix_inversion_tpu_torch", "--sizes",
           ",".join(map(str, CLI_SIZES)), "--preset", "low", *flags]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))

    def wait():
        try:
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{err}"
        lines = [line for line in out.splitlines() if "Error:" in line]
        assert sum(line.startswith("Average Error:") for line in lines) == 2 * len(CLI_SIZES), \
            f"{' '.join(cmd)}: {out}"
        return " ".join(flags) or "(no flags)", lines

    return wait


def serving_paths(dev, card, M, out, batch=MAIN_BATCH, digit_batch=DIGIT_BATCH,
                  batches=SERVE_BATCHES, tracked_batches=SERVE_TRACKED_BATCHES,
                  digit_batches=SERVE_DIGIT_BATCHES, e2e_batches=E2E_BATCHES,
                  e2e_repeats=E2E_REPEATS, precision_n=PRECISION_N, check=PRECISION_CHECK):
    """The serving pipeline and the user's tools on the card: the native
    marshaller against the numpy route bit for bit (packed on the main
    path's matrices ``M`` and output ``out``, digits at ``digit_batch``);
    ``StreamingInverter`` at HIGH n=4, packed (untracked and tracked) and
    digit I/O, each batch == ``inv.run`` and K1 once per batch, and a
    producer failure raised after two results; the e2e benchmark; the CLI in
    three subprocesses; the reference's error sweep, its first batch == the
    CPU's; and the debug tools on one matrix == the CPU.  Returns the e2e
    dict."""
    p = HIGH.replace(n=4)
    fmt = (p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    clis = [run_cli(flags) for flags in CLI_RUNS]  # they run while the rest does

    # -- the native marshaller against the numpy route, bit for bit
    host_out = tuple(o.cpu().numpy() for o in out)
    DM = M[:digit_batch]
    dinv = BatchedMatrixInversion(p, digit_batch, io="digits", device=dev)
    digit_out = dinv.run_raw(*dinv.quantize(DM)).cpu().numpy()
    for label, fn, size in (
        ("packed quantize", lambda: float_matrix_to_mags_and_signs(M, *fmt), M.shape[0]),
        ("packed dequantize", lambda: mags_and_signs_to_float_matrix(*host_out, *fmt), M.shape[0]),
        ("digit quantize", lambda: float_matrix_to_qfloat_arrays(DM, *fmt), digit_batch),
        ("digit dequantize",
         lambda: qfloat_and_signs_arrays_to_float_matrix(digit_out, *fmt[1:]), digit_batch),
    ):
        a, b, native_s, numpy_s = both_routes(fn)
        assert same_arrays(a, b), f"{label}: the native route != the numpy route"
        print(f"marshal {label} HIGH n=4 B={size}: native == numpy bit for bit (dtypes and "
              f"shapes too); host clock native {native_s:.4f} s, numpy {numpy_s:.4f} s, "
              f"{numpy_s / native_s:.2f}x ({os.cpu_count()} host cores; {card})")

    # -- StreamingInverter: packed, tracked, digits; then a producer failure
    inv = BatchedMatrixInversion(p, batch, io="packed", device=dev)
    rng = np.random.RandomState(90)
    Ms = [rng.randn(batch, 4, 4) * 100 for _ in range(batches)]
    results = streamed("HIGH n=4 packed", inv, Ms, "fused_inverse", card)
    tinv = BatchedMatrixInversion(p, batch, io="packed", track_overflow=True, device=dev)
    TMs = [overflowy(rng, batch, 4, 1024) for _ in range(tracked_batches)]
    tracked = streamed("HIGH n=4 packed tracked", tinv, TMs, "fused_inverse_tracked", card)
    assert all(r[1][:2048].all() for r in tracked), "stream: overflowy rows not flagged"
    streamed("HIGH n=4 digits", dinv, [rng.randn(digit_batch, 4, 4) * 100
                                       for _ in range(digit_batches)], "fused_inverse", card)
    got = []
    try:
        for r in StreamingInverter(inv, depth=2, finish_workers=2).run(
                [Ms[0], Ms[1], "not a matrix"]):
            got.append(r)
    except RuntimeError as exc:
        assert "producer failed" in str(exc) and isinstance(exc.__cause__, ValueError), exc
    else:
        raise AssertionError("stream: a producer failure in the third batch was not raised")
    assert len(got) == 2 and all(np.array_equal(g, r) for g, r in zip(got, results)), \
        "stream: the two batches before the failure were not delivered"
    print("stream: a producer failure in the third batch raised RuntimeError ('producer "
          "failed', from the ValueError) after two results, both == the stream's own")

    # -- the CLI, started at the top of the phase: done before the stage
    # timings' and the e2e benchmark's host clocks start
    for wait in clis:
        flags, lines = wait()
        print(f"CLI python -m matrix_inversion_tpu_torch --sizes "
              f"{','.join(map(str, CLI_SIZES))} --preset low {flags}: exit 0; "
              + "; ".join(line.strip() for line in lines if line.startswith("Average")))
    if dev.type == "cuda":
        stream_stages(card, inv, Ms[0])
    del Ms, results, TMs, tracked, got

    # -- the e2e benchmark: the device alone, then each marshalling route serial
    # and streamed
    t0 = time.perf_counter()
    e2e = run_benchmarks.e2e("high", 4, batch, e2e_batches, 2, e2e_repeats, 2, device=dev)
    print(f"e2e: host clock {time.perf_counter() - t0:.1f} s; {e2e_batches} batches a pass, "
          f"{e2e_repeats} passes a leg (the JAX benchmark's defaults: 8 and 3) ({card})")

    # -- the reference's error sweep: its first batch == the CPU's
    lp = LOW.replace(n=3)
    stats, got_counts = launches_of(
        lambda: precision.precision_benchmark(lp, N=precision_n, batch_size=check, device=dev))
    expect_launches("precision_benchmark", got_counts, fused_inverse=-(-precision_n // check))
    card_errors = precision.precision_errors(lp, N=check, batch_size=check, device=dev)
    cpu_errors = precision.precision_errors(lp, N=check, batch_size=check, device="cpu")
    assert np.array_equal(card_errors, cpu_errors), "precision sweep: the card != the CPU"
    print(f"precision_benchmark LOW n=3 N={precision_n}: {stats}; launches {got_counts}; the "
          f"first {check} per-matrix errors == the CPU run's bit for bit")

    # -- the debug tools on one HIGH n=4 matrix, against the CPU
    A = np.random.RandomState(91).randn(4, 4) * 100
    for fn, want in ((debug.run_qfloat_inverse, {"fused_inverse": 1}),
                     (debug.compare_plu, LU_LAUNCHES[4]),
                     (debug.debug_inverse, {"long_division_float": K2_LAUNCHES[4],
                                            "mul_window": K4_LAUNCHES[4]})):
        kw = {} if fn is debug.run_qfloat_inverse else {"verbose": False}
        card_out, got_counts = launches_of(lambda: fn(A, p, device=dev, **kw))
        expect_launches(fn.__name__, got_counts, **want)
        cpu_out = fn(A, p, device="cpu", **kw)
        if isinstance(card_out, dict):
            assert card_out.keys() == cpu_out.keys()
            for key, pair in card_out.items():
                assert pair == cpu_out[key] if key == "max_dev" else all(
                    np.array_equal(x, y) for x, y in zip(pair, cpu_out[key])), \
                    f"{fn.__name__} {key}: the card != the CPU"
        else:
            assert np.array_equal(card_out, cpu_out), f"{fn.__name__}: the card != the CPU"
        print(f"{fn.__name__} HIGH n=4, one matrix: launches {got_counts}; == the CPU run")
    return e2e


def time_op_kernels(dev, card, elems=KERNEL_ELEMS, launches=KERNEL_LAUNCHES,
                    call_elems=LARGE_BATCH):
    """K2, K3 and K4 alone and their plain versions at the High divide
    shape and the High dot-product multiply, and K2 and K3 at the High
    reciprocal (a one-word dividend); each a median of REPS passes of
    ``launches`` calls (of one call for K4's plain versions, tens of
    milliseconds each).  Every kernel is first held against the plain
    version on all the timed elements, tolerance 0.  Then K2, K3 and K4 at
    ``call_elems``, the size of one call on the n=16 path, beside the bound
    at that size.  Returns two dicts ``{name: (ms, plain_ms, library_ms)}``,
    the second for K2 and K3 at the reciprocal; ``library_ms`` is the time
    of the one PyTorch call that computes a kernel's function
    (``torch.div`` with floor rounding for the divisions; the multiply has
    none)."""
    g = torch.Generator(device=dev).manual_seed(21)
    v = torch.randint(0, 1 << 60, (elems,), dtype=torch.int64, device=dev, generator=g)
    d = torch.randint(1, 1 << 40, (elems,), dtype=torch.int64, device=dev, generator=g)
    a = torch.randint(0, 1 << 40, (elems,), dtype=torch.int64, device=dev, generator=g)
    b = torch.randint(0, 1 << 40, (elems,), dtype=torch.int64, device=dev, generator=g)
    one = torch.full((), 1 << 60, dtype=torch.int64, device=dev)

    def timed(fn):
        return timed_ms(fn, dev, launches=launches)

    shapes = {}
    for shape, x, n_bits in (("divide", v, 60), ("reciprocal", one, 61)):
        kernels = {
            "long_division_float":
                lambda: long_division.batched_long_division_float(x, d, n_bits, 15),
            "long_division_classic":
                lambda: long_division.batched_long_division(x, d, n_bits, 1),
        }
        ref = packed.packed_long_division_reference(x, d, n_bits)
        for name, run in kernels.items():
            assert torch.equal(run(), ref), \
                f"{name} differs from the plain version on the {elems} timed elements ({shape})"
        del ref
        plain = timed(lambda: packed.packed_long_division_reference(x, d, n_bits))
        library = timed(lambda: torch.div(x, d, rounding_mode="floor"))
        shapes[shape] = {name: (timed(run), plain, library) for name, run in kernels.items()}
        print(f"check and time, High {shape} (n_bits {n_bits}, divisor < 2**40"
              f"{', the dividend one word' if shape == 'reciprocal' else ''}): both kernels == "
              f"plain version on all {elems} elements (tolerance 0); torch.div floor alone (the "
              f"library call of K2 and K3) {library:.3f} ms; "
              + "; ".join(f"{name} {ms:.3f} ms" for name, (ms, _, _) in shapes[shape].items())
              + f"; plain version {plain:.3f} ms; {launches} calls a pass ({card})")
    times = dict(shapes["divide"])
    def mul():
        return long_division.batched_mul_window(a, b, *HIGH_MUL)

    def mul_plain():
        return packed.mul_window_packed(a, 40, 20, b, 40, 20, 40, 20, 1)[0]

    assert torch.equal(mul(), mul_plain()), \
        f"mul_window differs from the plain version on the {elems} timed elements"
    times["mul_window"] = (timed(mul), timed_ms(mul_plain, dev), None)
    trunc_ms = timed_ms(lambda: packed.mul_trunc_packed(a, 40, 20, b, 40, 20, 40, 20, 1), dev)
    ms, plain, _ = times["mul_window"]
    print(f"check and time mul_window alone: == plain version on all {elems} elements (tolerance "
          f"0); {ms:.3f} ms, plain version {plain:.3f} ms (High dot product (40, 20) x (40, 20) "
          f"-> (40, 20); {launches} calls a pass; {card})")
    print(f"time mul_trunc_packed (the CPU route's multiply) on the card: {trunc_ms:.3f} ms "
          f"on {elems} elements ({card})")

    # at the size of one call on the n=16 path: a call through the wrapper
    # (what the path pays, the host's part included) and the kernel alone,
    # as `launches` bare launches replayed from one CUDA graph
    cv, cd, ca, cb = (t[:call_elems] for t in (v, d, a, b))
    out = torch.empty_like(cd)
    t1, nt, nl = long_division.mul_trunc_format(*HIGH_MUL)
    small = {
        "long_division_float": (lambda: long_division.batched_long_division_float(cv, cd, 60, 15),
                                (cv, cd, 1, 60, 15)),
        "long_division_classic": (lambda: long_division.batched_long_division(cv, cd, 60, 1),
                                  (cv, cd, 1, 60, 1)),
        "mul_window": (lambda: long_division.batched_mul_window(ca, cb, *HIGH_MUL),
                       (ca, cb, 1, t1, nt, nl)),
    }
    runs = {"torch.div floor": lambda: torch.div(cv, cd, rounding_mode="floor")}
    graphs = {}
    for name, (wrapper, (x, y, *args)) in small.items():
        runs[f"{name} through its wrapper"] = wrapper
        if dev.type == "cuda":
            launch = functools.partial(long_division._libraries()[name], x.data_ptr(),
                                       y.data_ptr(), out.data_ptr(), call_elems, *args)
            graphs[f"{name} alone"] = replay_of(
                lambda launch=launch: launch(torch.cuda.current_stream().cuda_stream), launches)
    bound = 24 * call_elems / HBM_BYTES_PER_S * 1e3
    for label, ms in {**timed_in_turns(runs, dev, rounds=REPS, launches=launches),
                      **{label: ms / launches for label, ms in
                         timed_in_turns(graphs, dev, rounds=REPS).items()}}.items():
        how = (f"{launches} launches replayed from a CUDA graph" if label in graphs
               else f"{launches} calls a pass")
        print(f"time {label} at {call_elems} elements (one call of the n=16 path; High divide or "
              f"dot product): {ms * 1e3:.2f} us a call, {how}, in turns; bound "
              f"{bound * 1e3:.2f} us by bytes (24 B an element) ({card})")
    return times, shapes["reciprocal"]


def division_design_steps(dev, card, elems=KERNEL_ELEMS):
    """The steps of the division kernels' and the multiply's designs in
    turns, each held against ``torch.div`` or the port's K4 first
    (``utils/division_steps.py``); the multiply's with registers, spills
    and static SASS."""
    for row in division_steps.measure(dev, elems):
        bound = row["bytes_per_element"] * elems / HBM_BYTES_PER_S * 1e3
        line = (f"design step, {row['shape']}: {row['step']}: {row['ms']:.4f} ms on {elems} "
                f"elements (bound {bound:.3f} ms by bytes, {row['bytes_per_element']} B an "
                "element")
        if "registers" in row:
            line += (f"; {row['registers']} registers, spills: {row['spills'] or 'none'}; "
                     f"{row['sass_instructions']} static SASS instructions in the body, "
                     f"{row['sass_per_element']:.2f} an element")
        print(line + f"; {card}; right after the shape's timings: {row['card_after']})")


def k1_design_steps(dev, card, batch=MAIN_BATCH):
    """The steps of K1's design in turns, each held to the port's own build
    first (``utils/fused_steps.py``); returns ``{step: ms}``."""
    times = {}
    for row in fused_steps.measure(dev, batch):
        times[row["step"]] = row["ms"]
        print(f"K1 design step, {row['step']}: {row['ms']:.4f} ms at HIGH n=4, B={batch}; "
              f"{row['registers']} registers, spills: {'; '.join(row['spills']) or 'none'}; "
              f"{row['sass_instructions']} static SASS instructions, {row['sass_calls']} calls; "
              f"built with {' '.join(row['defines']) or 'no define'} ({card})")
    return times


def differing_bytes(a, b):
    """Bytes in which two tensors of one dtype and shape differ (0: the
    same bits, also for inf and NaN)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    return int((a.contiguous().view(torch.uint8) != b.contiguous().view(torch.uint8)).sum())


def check_ubench(dev, rows=UBENCH_ROWS):
    """K5 == the plain version on every mix, tolerance 0: C = 8 and C = 1 at
    K = 64 on a ragged (33, 128) input, and C = 8 at the measurement's own
    width (``rows``, 128), whose grid the rates come from, at a K that runs
    the unrolled loop's remainder; returns the differing bytes (0)."""
    for name in ubench.LAUNCHES:
        ubench.LAUNCHES[name] = 0
    worst = 0
    for name, (_, dtype, _) in ubench.MIXES.items():
        full_k = UBENCH_CELL_CHECK_K if dtype == torch.int64 else UBENCH_CHECK_K
        for shape_rows, K, C in ((33, 64, UBENCH_C), (33, 64, 1), (rows, full_k, UBENCH_C)):
            x, y = ubench.make_inputs(name, shape_rows, dev, seed=500 + C + shape_rows)
            got = ubench.ubench_chain(name, x, y, K, C)
            ref = ubench.ubench_reference(name, x, y, K, C)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = differing_bytes(got, ref)
            worst = max(worst, err)
            assert err == 0, (f"ubench {name} ({shape_rows}, 128) K={K} C={C}: kernel differs "
                              "from the plain version")
        assert ubench.LAUNCHES[name] == 3, f"ubench {name}: {ubench.LAUNCHES[name]} launches"
        print(f"check ubench {name}: (33, 128) {dtype}, K=64, C={UBENCH_C} and C=1, and "
              f"({rows}, 128), K={full_k}, C={UBENCH_C}: kernel == plain version bit for bit "
              "(tolerance 0)")
    return worst


def measure_ubench(dev, card, rows=UBENCH_ROWS, reps=UBENCH_REPS, passes=UBENCH_PASSES):
    """Nominal ops/s of every mix at full width from three K values; returns
    ``({mix: ops/s}, ms of one u32_kernelmix launch at its largest K)``.

    Raises if a mix's two slopes differ by more than SLOPES_AGREE_WITHIN of
    the smaller, if a uint32 or float32 mix compiled to fewer than half an
    instruction per nominal op (a folded chain; only a convert is free), or
    if a mix's instruction rate reads above 105% of the card's issue limit.
    """
    sass = ubench.sass_loop_instructions() if dev.type == "cuda" else {}
    regs = ubench.ptxas_registers() if dev.type == "cuda" else {}
    print(f"clocks.sm, clocks.mem, power.draw, temperature before the probes: {card_state() if dev.type == 'cuda' else 'n/a'}")
    rates, kernelmix_ms = {}, None
    for name, (_, dtype, nops) in ubench.MIXES.items():
        ks = UBENCH_CELL_KS if dtype == torch.int64 else UBENCH_KS
        per_k = UBENCH_C * rows * 128 * nops * reps  # nominal ops per unit of K and pass
        ts = [ubench.chain_seconds(name, k, rows, UBENCH_C, reps, passes, dev) for k in ks]
        slopes = [(ks[i + 1] - ks[i]) * per_k / (ts[i + 1] - ts[i]) for i in (0, 1)]
        assert min(slopes) > 0 and abs(slopes[0] - slopes[1]) <= SLOPES_AGREE_WITHIN * min(slopes), \
            f"ubench {name}: the time is not linear in K (slopes {slopes})"
        rate = (ks[2] - ks[0]) * per_k / (ts[2] - ts[0])
        rates[name] = rate
        line = (f"ubench {name}: {rate:.4e} nominal ops/s (K {ks[0]}->{ks[2]}; slopes "
                f"{slopes[0]:.4e}, {slopes[1]:.4e}; {ts[2] / reps * 1e3:.3f} ms per launch at "
                f"K={ks[2]}; rows {rows}, C {UBENCH_C}")
        if (name, UBENCH_C) in sass:
            instrs, calls = sass[(name, UBENCH_C)]
            per_op = instrs / (ubench.UNROLL[dtype] * UBENCH_C * nops)
            r = regs[(name, UBENCH_C)]
            line += (f"; {per_op:.3f} SASS instructions per nominal op"
                     + (f" and {calls // (UBENCH_C * nops)} call(s)" if calls else "")
                     + f"; {r} registers, {ubench.resident_warps(r)} warps per SM")
            share = rate * per_op / roofline.PUBLISHED_ISSUE_RATE_H100
            assert share <= 1.05, (
                f"ubench {name}: {rate * per_op:.4e} instructions/s is {share:.1%} of the "
                "card's issue limit: the chain was folded or the timing is wrong")
            if dtype != torch.int64:
                assert per_op >= 0.5, f"ubench {name}: {per_op:.3f} instructions per nominal op"
                line += (f"; {rate / roofline.PUBLISHED_INT32_RATE_H100:.1%} of the published "
                         f"INT32 peak {roofline.PUBLISHED_INT32_RATE_H100:.3e}, instructions at "
                         f"{share:.1%} of the issue limit")
        print(line + f"; {card})")
        if name == "u32_kernelmix":
            kernelmix_ms = ts[2] / reps * 1e3
    print(f"clocks.sm, clocks.mem, power.draw, temperature after the probes: {card_state() if dev.type == 'cuda' else 'n/a'}")
    return rates, kernelmix_ms


def time_ubench_plain(dev, card, rows=UBENCH_ROWS):
    """The plain version of the u32_kernelmix launch at the kernel's own K
    (the largest of UBENCH_KS): median of 3 passes after a short warm-up
    chain through the same torch ops."""
    x, y = ubench.make_inputs("u32_kernelmix", rows, dev)
    ubench.ubench_reference("u32_kernelmix", x, y, 8, UBENCH_C)
    ms = timed_ms(lambda: ubench.ubench_reference("u32_kernelmix", x, y, UBENCH_KS[2], UBENCH_C),
                  dev, passes=3, warm_up=False)
    print(f"time ubench plain version (u32_kernelmix, rows {rows}, C {UBENCH_C}, "
          f"K={UBENCH_KS[2]}): {ms:.3f} ms ({card})")
    return ms


def cell_rates(rates):
    """``measured_rates`` of ``kernel_roofline`` for the body as it is: each
    of the port's cell primitives at its own mix's rate (a reciprocal is the
    same 64-bit division as a true division; a tracked add or division
    differs from the untracked one by a compare), everything else at
    u32_kernelmix's."""
    return {
        "mul": rates["cell_mul"],
        "sadd": rates["cell_sadd"], "sadd_t": rates["cell_sadd"],
        "mul_window_t": rates["cell_mul_window_t"],
        "divide": rates["cell_divide"], "invert": rates["cell_divide"],
        "divide_t": rates["cell_divide"], "invert_t": rates["cell_divide"],
        "default": rates["u32_kernelmix"],
    }


def static_sass(library):
    """``(instructions, calls)`` in the SASS of a built library, NOPs left
    out: for a straight-line kernel, what one thread issues, a subroutine's
    instructions counted once however often it is called."""
    instrs = [i for fn in sass.functions(sass.dump(library)).values() for i in fn]
    return len(instrs), sass.calls(instrs)


def op_kernel_sass():
    """Instructions per element that K2, K3 and K4 issue at the timed
    shapes, read from the built libraries' SASS, as ``{name: (instructions
    per element, note)}``: the straight-line body of the
    four-elements-a-thread kernel, up to its EXIT, over four (K2's IEEE
    divide keeps a slow path behind a call, never taken here and not
    counted); for K4 the High dot product's instance.  Beside K4 the first
    K4 (the steps library's row table, one element a thread): its unrolled
    rows up to the exit after the High dot product's last row, and the
    common end.  Raises if K3 holds a floating-point opcode or a call (the
    64-bit division is one), or if K2 holds a conversion to or from a 64-bit
    type; the first K2, kept in the design-steps library, must hold one,
    which shows that the search sees them."""
    libraries = {name: sass.functions(sass.dump(long_division.build_dir(name) / f"lib{name}.so"))
                 for name in ("long_division", "mul_window")}
    out = {}
    for name, (library, kernel) in OP_SASS_KERNELS.items():
        (instrs,) = [i for fn, i in libraries[library].items() if kernel in fn]
        body = sass.main_body(instrs)
        out[name] = (len(body) / OP_ELEMS_PER_THREAD,
                     f"{len(body)} in the body of 4 elements, {len(instrs) - len(body)} behind "
                     f"{sass.calls(instrs)} calls")
    division = libraries["long_division"]
    classic = [op for fn, i in division.items() if "Classic" in fn for _, op in i]
    floats = sorted({sass.opcode(op) for op in classic if FLOAT_OPCODES.match(sass.opcode(op))})
    assert not floats and not any(re.search(r"\bCALL\b", op) for op in classic), \
        f"K3 holds floating-point opcodes {floats} or a call"
    wide = [op for fn, i in division.items() if "Float" in fn for _, op in i
            if WIDE_CONVERSION.search(op)]
    assert not wide, f"K2 converts to or from a 64-bit type: {wide[:3]}"
    steps = sass.functions(sass.dump(division_steps.library_path()))
    first = [op for fn, i in steps.items() if "FirstFloat" in fn for _, op in i
             if WIDE_CONVERSION.search(op)]
    assert first, "the first K2 shows no 64-bit conversion: the search is blind"
    print(f"sass: K3's kernels hold no floating-point opcode and no call; K2's kernels no "
          f"conversion to or from a 64-bit type (the first K2 holds {len(first)}, e.g. "
          f"{first[0].split()[0]})")
    first_mul = steps[division_steps.kernel_name(steps, "one element per thread", "first K4")]
    exits, end = sass.forward_exits(first_mul)
    rows = sum(1 for c in packed.mul_window_consts(*HIGH_MUL, 1) if c[2] != 0)
    assert len(exits) > rows, f"the first K4: {len(exits)} exits for {rows} rows"
    first_issued = sum(1 for addr, _ in first_mul if addr <= exits[rows] or addr >= end)
    out["mul_window"] = (out["mul_window"][0], out["mul_window"][1] + (
        f"; the first K4, one element a thread, {first_issued} at the High dot product's {rows} "
        f"rows of {len(first_mul)} static instructions for {len(exits)} rows"))
    print(f"sass: K4 at the High dot product {out['mul_window'][0]:.2f} instructions an element "
          f"({out['mul_window'][1]})")
    return out


def k1_bytes(n, batch, track):
    """Bytes K1 must move: n*n cells of an int64 magnitude and an int64 sign,
    read and written, and the tracked kernel's int32 flag."""
    return batch * (n * n * 16 * 2 + (4 if track else 0))


def roofline_path(dev, card, rates, op_times, op_issued, batch=MAIN_BATCH, elems=KERNEL_ELEMS):
    """kernel_roofline over K1's emitted body with K1's time from this run,
    HIGH n = 2..5, untracked and tracked.  The bound: the fewest
    instructions known for each primitive's function, the multiplies'
    shared operands charged once, over u32_kernelmix's measured rate, or
    the bytes over the memory rate where that is more; raises when K1 reads
    over 105% of it.  Beside it the time that the body as written takes at
    its own primitives' rates, each measured alone: not a bound, K1 may
    pass it where multiplies share work.  Then the same two figures for K2,
    K3 and K4, the issued one from ``op_issued`` (:func:`op_kernel_sass`).
    Returns {(n, track): roofline dict of the bound}."""
    default_rate = {"default": rates["u32_kernelmix"]}
    g = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for track in (False, True):
        for n in (2, 3, 4, 5):
            p = HIGH.replace(n=n)
            # random x100 matrices quantized on the card, cell-major
            M = torch.randn(n * n, batch, device=dev, generator=g, dtype=torch.float64) * 100
            cm = (M.abs() * (1 << p.frac)).to(torch.int64)
            cs = torch.where(M < 0, -1, 1)
            ms = timed_ms(lambda: fused_inverse.fused_inverse_cell_major(
                cm, cs, *config_of(p), track=track), dev)
            r = roofline.kernel_roofline(batch / ms * 1e3, n, "high", default_rate, track)
            ops_ms = batch / r["roofline_inversions_per_s_measured_rates"] * 1e3
            bytes_ms = k1_bytes(n, batch, track) / HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            share = 100.0 * bound_ms / ms
            assert share <= 105.0, (
                f"K1 HIGH n={n} track={track}: {ms:.3f} ms is under its bound {bound_ms:.3f} ms "
                f"({share:.2f}%): the count of operations is too high or a rate too low")
            as_written = roofline.kernel_roofline(batch / ms * 1e3, n, "high", cell_rates(rates), track)
            written_ms = batch / as_written["roofline_inversions_per_s_measured_rates"] * 1e3
            instrs, calls = static_sass(
                fused_inverse.build_dir(config_of(p) + ((True,) if track else ())) / "libfused_inverse.so")
            print(f"roofline K1 HIGH n={n}{' tracked' if track else ''}: "
                  f"{int(r['ops_per_inversion_kernel'])} primitives per inversion "
                  f"{ {k: int(v) for k, v in r['kernel_op_histogram'].items()} }, multiplies on "
                  f"{r['distinct_mul_operands'][0]} distinct first and "
                  f"{r['distinct_mul_operands'][1]} distinct second operands; "
                  f"{int(r['nominal_instructions_per_inversion'])} nominal instructions by the "
                  f"cheapest way known = {ops_ms:.3f} ms at B={batch} over the u32_kernelmix "
                  f"rate, bytes {bytes_ms:.3f} ms: bound {bound_ms:.3f} ms by "
                  f"{'operations' if ops_ms > bytes_ms else 'bytes'}; K1 {ms:.3f} ms, the bound "
                  f"is {share:.2f}% of it.  Issued: {instrs} static SASS instructions "
                  f"({calls} calls of the division routine and the multiply, each counted once); "
                  "the body's own "
                  f"primitives at their rates alone take {written_ms:.3f} ms, K1 reads "
                  f"{as_written['mfu_pct_vs_measured_roofline']}% of that ({card})")
            out[(n, track)] = r
    memory_ms = 24 * elems / HBM_BYTES_PER_S * 1e3
    for name, function in OP_KERNEL_FUNCTION.items():
        instrs = roofline._PRIM_NOMINAL_INSTR[function]
        ops_ms = instrs * elems / rates["u32_kernelmix"] * 1e3
        issued, note = op_issued[name]
        issued_ms = issued * elems / rates["u32_kernelmix"] * 1e3
        bound_ms = max(ops_ms, memory_ms)
        ms, plain_ms, library_ms = op_times[name]
        assert bound_ms <= 1.05 * min(t for t in op_times[name] if t is not None), \
            f"{name}: bound {bound_ms:.3f} ms is over a measured time {op_times[name]}"
        print(f"bound {name}: its function ({function}) needs {instrs:.0f} nominal instructions "
              f"per element by the cheapest way known = {ops_ms:.3f} ms over the u32_kernelmix "
              f"rate, memory (24 B per element at 3.35 TB/s) {memory_ms:.3f} ms, on {elems} "
              f"elements: bound {bound_ms:.3f} ms by "
              f"{'operations' if ops_ms > memory_ms else 'bytes'}; measured {ms:.3f} ms.  Issued: "
              f"{issued:.1f} instructions per element by its own algorithm, read from its "
              f"SASS ({note}) = {issued_ms:.3f} ms ({card})")
    return out


def published_bound(bytes_moved, instructions, *times):
    """``(bound_ms, bound_by)``: the larger of the bytes over the card's
    published memory rate and the 32-bit instructions over its published
    issue limit.  Raises if that is over 105% of a time in ``times``, each
    measured for the same function on the same inputs: a bound that a
    measurement beats counts too much."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = instructions / roofline.PUBLISHED_ISSUE_RATE_H100 * 1e3
    bound = max(by_ops, by_bytes)
    measured = [t for t in times if t is not None]
    assert all(bound <= 1.05 * t for t in measured), \
        f"bound {bound:.3f} ms ({by_ops:.3f} operations, {by_bytes:.3f} bytes) is over {measured}"
    return bound, "operations" if by_ops > by_bytes else "bytes"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")

    # -- build every kernel of every path from the sources in the checkout,
    # one nvcc per library, all started together
    t0 = time.perf_counter()
    tracked_configs = [config_of(p) + (True,) for _, p in TRACKED_CHECKS]
    # K1 at the CLI's LOW sizes too, which its subprocesses then load
    cli_configs = [config_of(LOW.replace(n=n)) for n in CLI_SIZES]
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        fused_build = pool.submit(
            timed_s, fused_inverse.build,
            [config_of(p) for _, p, _ in CHECKS] + tracked_configs + cli_configs)
        op_build = pool.submit(timed_s, long_division.build)
        ubench_build = pool.submit(timed_s, ubench.build)
        steps_build = pool.submit(timed_s, division_steps.build)
        k1_steps_build = pool.submit(timed_s, fused_steps.build)
        native_build = pool.submit(timed_s, native.build)
        fused_s, op_s, ubench_s = fused_build.result(), op_build.result(), ubench_build.result()
        steps_s, k1_steps_s = steps_build.result(), k1_steps_build.result()
        native_s = native_build.result()
    print(f"build: {len(CHECKS)} fused_inverse + {len(TRACKED_CHECKS)} tracked kernels + "
          f"{len(cli_configs)} at the CLI's sizes (LOW n in {CLI_SIZES}) "
          f"from {fused_inverse.CSRC} with nvcc {' '.join(fused_inverse.NVCC_FLAGS)} "
          f"in {fused_s:.1f} s; long_division + mul_window libraries in {op_s:.1f} s; "
          f"the ubench library ({len(ubench.MIXES)} mixes x C in {ubench.CHAIN_COUNTS}) in "
          f"{ubench_s:.1f} s; the division design-steps library in {steps_s:.1f} s; the "
          f"{len({(t, d) for _, t, d, _ in fused_steps.STEPS})} builds of K1's design steps in "
          f"{k1_steps_s:.1f} s; the native marshaller ({native.SOURCE}) with g++ "
          f"{' '.join(cuda_build.HOST_FLAGS)} in {native_s:.1f} s; all in "
          f"{time.perf_counter() - t0:.1f} s")
    main_config = config_of(HIGH.replace(n=4))
    for label, c in (("fused_inverse", main_config), ("fused_inverse_tracked", main_config + (True,))):
        print(f"ptxas {label} HIGH n=4: {ptxas_info(fused_inverse.build_dir(c))}")
    for name in ("long_division", "mul_window"):
        log = (long_division.build_dir(name) / "nvcc.log").read_text()
        regs = {re.sub(r"^_ZN6sframe|EEvPKm.*$", "", entry): r
                for entry, r in sass.ptxas_registers(log).items()}
        print(f"ptxas {name}, registers: {regs}; spills: {sass.ptxas_spill_lines(log) or 'none'}")
    ubench_regs = ubench.ptxas_registers()
    print(f"ptxas ubench, registers of the C={UBENCH_C} kernels: "
          f"{ {name: ubench_regs[(name, UBENCH_C)] for name in ubench.MIXES} }; spills: "
          f"{ubench.ptxas_spill_lines() or 'none'}")

    # -- kernel vs plain version on the card, bit for bit, through both layouts
    max_err = 0
    for i, (label, p, singular) in enumerate(CHECKS):
        rng = np.random.RandomState(100 + i)
        M = rng.randn(CHECK_BATCH, p.n, p.n) * (1 if singular else 100)
        if singular:
            M[:, 2, :] = M[:, 0, :] + M[:, 1, :]  # rank-deficient
        err, _ = check_k1(dev, label, p, M, track=False)
        max_err = max(max_err, err)
        print(f"check {label}: B={CHECK_BATCH}, kernel == plain version bit for bit through "
              "(B, n*n) and cell-major (tolerance 0 on magnitudes and signs)")

    # -- tracked kernel vs tracked plain version on the card, bit for bit
    tracked_err = 0
    for i, (label, p) in enumerate(TRACKED_CHECKS):
        M = overflowy(np.random.RandomState(200 + i), CHECK_BATCH, p.n, rows=1)
        err, got = check_k1(dev, f"tracked {label}", p, M, track=True)
        tracked_err = max(tracked_err, err)
        flagged = int(got[2].sum())
        assert got[2].dtype == torch.int32 and 0 < flagged < CHECK_BATCH, \
            f"tracked {label}: {flagged} flagged of {CHECK_BATCH}"
        assert int(got[2][0]) == 1 and int(got[2][1]) == 1, f"tracked {label}: overflow not flagged"
        print(f"check tracked {label}: B={CHECK_BATCH}, {flagged} flagged; kernel == plain "
              "version bit for bit through (B, n*n) and cell-major (tolerance 0 on magnitudes, "
              "signs and flags)")

    # -- what a caller's (B, n*n) tensors may be: ragged, one matrix, off
    # 16-byte alignment, not contiguous
    layout_err = check_k1_layouts(dev)
    max_err, tracked_err = max(max_err, layout_err[False]), max(tracked_err, layout_err[True])

    # -- the main path: quantize, run_raw on CUDA tensors, dequantize
    p = HIGH.replace(n=4)
    inv = BatchedMatrixInversion(p, MAIN_BATCH, device="cuda", backend="packed", io="packed")
    M = np.random.RandomState(0).randn(MAIN_BATCH, 4, 4) * 100
    t0 = time.perf_counter()
    mags, signs = inv.quantize(M)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    reset_counts()
    out = inv.run_raw(mags, signs)
    torch.cuda.synchronize()
    launches = fused_inverse.LAUNCHES
    assert launches == 1, f"the main path launched the fused kernel {launches} times, not once"
    assert fused_inverse.TRACKED_LAUNCHES == 0, "the untracked path launched the tracked kernel"
    t0 = time.perf_counter()
    res = inv.dequantize(out)
    dequantize_s = time.perf_counter() - t0
    assert out[0].shape == (MAIN_BATCH, 16) and res.shape == (MAIN_BATCH, 4, 4)
    assert np.isfinite(res).all()
    ref = fused_inverse.fused_matrix_inverse_reference(mags, signs, *config_of(p))
    err = max_abs_diff(out, ref)
    max_err = max(max_err, err)
    assert err == 0, f"main path differs from the plain version on the card (max {err})"
    cpu = fused_inverse.fused_matrix_inverse_reference(
        mags[:256].cpu(), signs[:256].cpu(), *config_of(p)
    )
    assert all(torch.equal(o[:256].cpu(), c) for o, c in zip(out, cpu)), \
        "main path differs from the CPU plain path"
    mae = float(np.mean(np.abs(res[:64] - np.linalg.inv(M[:64]))))
    assert mae < 1e-3, f"mean absolute error {mae} against np.linalg.inv"
    print(f"main path: HIGH n=4 B={MAIN_BATCH}: {launches} kernel launch(es); "
          "== plain version on the card (all) and on the CPU (first 256); "
          f"mean abs error vs np.linalg.inv on 64 matrices {mae:.3e}")
    print(f"host clock, one pass: quantize + H2D {quantize_s:.3f} s, "
          f"D2H + dequantize {dequantize_s:.3f} s")

    # -- the tracked main path: the same stages with track_overflow=True
    tinv = BatchedMatrixInversion(p, MAIN_BATCH, device="cuda", backend="packed", io="packed",
                                  track_overflow=True)
    rows = 1024
    TM = overflowy(np.random.RandomState(0), MAIN_BATCH, 4, rows)
    tmags, tsigns = tinv.quantize(TM)
    torch.cuda.synchronize()
    reset_counts()
    tout = tinv.run_raw(tmags, tsigns)
    torch.cuda.synchronize()
    tracked_launches = fused_inverse.TRACKED_LAUNCHES
    assert tracked_launches == 1, \
        f"the tracked main path launched the tracked kernel {tracked_launches} times, not once"
    assert fused_inverse.LAUNCHES == 0, "the tracked main path launched the untracked kernel"
    tres, tflags = tinv.dequantize(tout)
    assert len(tout) == 3 and tout[2].shape == (MAIN_BATCH,) and tout[2].dtype == torch.int32
    assert tres.shape == (MAIN_BATCH, 4, 4) and np.isfinite(tres).all()
    assert tflags.dtype == np.int32 and tflags.shape == (MAIN_BATCH,)
    tref = fused_inverse.fused_matrix_inverse_reference(tmags, tsigns, *config_of(p), track=True)
    err = max_abs_diff(tout, tref)
    tracked_err = max(tracked_err, err)
    assert err == 0, f"tracked main path differs from the plain version on the card (max {err})"
    tcpu = fused_inverse.fused_matrix_inverse_reference(
        tmags[:256].cpu(), tsigns[:256].cpu(), *config_of(p), track=True
    )
    assert all(torch.equal(o[:256].cpu(), c) for o, c in zip(tout, tcpu)), \
        "tracked main path differs from the CPU plain path"
    untracked = fused_inverse.fused_matrix_inverse(tmags, tsigns, *config_of(p))
    assert all(torch.equal(o, u) for o, u in zip(tout[:2], untracked)), \
        "tracked magnitudes and signs differ from the untracked kernel's"
    assert tflags[:2 * rows].all(), "near-singular or zero matrices not flagged"
    sample = slice(2 * rows, 2 * rows + 16384)
    ok = tflags[sample] == 0
    tmae = float(np.mean(np.abs(tres[sample][ok] - np.linalg.inv(TM[sample][ok]))))
    assert tmae < 1e-3, f"mean absolute error {tmae} of unflagged matrices against np.linalg.inv"
    print(f"tracked main path: HIGH n=4 B={MAIN_BATCH}: {tracked_launches} tracked kernel "
          f"launch(es); {int(tflags.sum())} flagged (the {2 * rows} overflowy rows and "
          f"{int(tflags[2 * rows:].sum())} random); == plain version on the card (all) and on "
          "the CPU (first 256), flags included; magnitudes and signs == untracked kernel; "
          f"mean abs error vs np.linalg.inv on {int(ok.sum())} unflagged matrices {tmae:.3e}")

    # -- one run_raw of each main path under the profiler: K1 and nothing
    # else; and one reciprocal: the division kernel and no fill
    check_launches_under_profiler(dev, inv, mags, signs, tinv, tmags, tsigns)

    # -- the op-by-op path's kernels vs their plain versions on the card
    op_err = {**check_division_kernels(dev), "mul_window": check_mul_kernel(dev)}

    # -- the op-by-op paths: HIGH n=16 (K2), classic (K3), K4, tracked, n=4
    t0 = time.perf_counter()
    op_launches = large_n_paths(dev, card)
    print(f"host clock: the op-by-op paths, checks and timings, {time.perf_counter() - t0:.1f} s")

    # -- digit I/O: the digit path at n=4 and n=16, EncryptedMatrixInversion,
    # the partial circuits
    t0 = time.perf_counter()
    digit_paths(dev, card)
    print(f"host clock: the digit-I/O paths, checks and timings, {time.perf_counter() - t0:.1f} s")

    # -- the serving pipeline and the user's tools: the native marshaller,
    # StreamingInverter, the e2e benchmark, the CLI, the error sweep, the debug
    # tools
    t0 = time.perf_counter()
    e2e = serving_paths(dev, card, M, out)
    print(f"host clock: the serving paths and the user's tools, {time.perf_counter() - t0:.1f} s")

    # -- timings (CUDA events, median of REPS after a warm-up)
    t0 = time.perf_counter()
    op_times, reciprocal_times = time_op_kernels(dev, card)
    division_design_steps(dev, card)
    print("host clock: the op-by-op kernels' checks and timings at "
          f"{KERNEL_ELEMS} elements and the design steps, {time.perf_counter() - t0:.1f} s")
    # K1 as run_raw launches it, (B, n*n), and run_raw, in turns beside the
    # cell-major layout and beside what they replaced: four transposed copies
    # around the kernel as first ported (kept in the design-steps builds)
    def as_before(m, s, track):
        """run_raw as it was: (B, 16) -> (16, B) copies, the first kernel,
        and the copies back."""
        cm, cs = m.t().contiguous(), s.t().contiguous()
        out = [torch.empty_like(cm), torch.empty_like(cs)]
        if track:
            out.append(torch.empty(m.shape[0], dtype=torch.int32, device=dev))
        first = fused_steps.FIRST_TRACKED if track else fused_steps.FIRST
        fused_steps.run_step(track, first, fused_steps.CELL_MAJOR, cm, cs, out)
        return (out[0].t().contiguous(), out[1].t().contiguous(), *out[2:])

    assert all(torch.equal(a, b) for a, b in zip(as_before(mags, signs, False), out))
    assert all(torch.equal(a, b) for a, b in zip(as_before(tmags, tsigns, True), tout))
    cm, cs = mags.t().contiguous(), signs.t().contiguous()
    tcm, tcs = tmags.t().contiguous(), tsigns.t().contiguous()
    config = config_of(p)
    k1_turns = timed_in_turns({
        "K1 (B, n*n)": lambda: fused_inverse.fused_matrix_inverse(mags, signs, *config),
        "K1 cell-major (n*n, B)": lambda: fused_inverse.fused_inverse_cell_major(cm, cs, *config),
        "tracked K1 (B, n*n)":
            lambda: fused_inverse.fused_matrix_inverse(tmags, tsigns, *config, track=True),
        "tracked K1 cell-major (n*n, B)":
            lambda: fused_inverse.fused_inverse_cell_major(tcm, tcs, *config, track=True),
    }, dev, launches=K1_LAUNCHES)
    run_raws = {
        "run_raw": lambda: inv.run_raw(mags, signs),
        "run_raw as before (transposes around the first kernel)":
            lambda: as_before(mags, signs, False),
        "tracked run_raw": lambda: tinv.run_raw(tmags, tsigns),
        "tracked run_raw as before (transposes around the first kernel)":
            lambda: as_before(tmags, tsigns, True),
    }
    # one call between two events reads the host's part of the call too (the
    # card idles until the launch arrives); K1_LAUNCHES calls a pass hide it
    run_raw_turns = timed_in_turns(run_raws, dev)
    queued_turns = timed_in_turns(run_raws, dev, launches=K1_LAUNCHES)
    kernel_ms, tkernel_ms = k1_turns["K1 (B, n*n)"], k1_turns["tracked K1 (B, n*n)"]
    run_raw_ms, trun_raw_ms = run_raw_turns["run_raw"], run_raw_turns["tracked run_raw"]
    plain_ms = timed_ms(
        lambda: fused_inverse.fused_matrix_inverse_reference(mags, signs, *config), dev)
    tplain_ms = timed_ms(lambda: fused_inverse.fused_matrix_inverse_reference(
        tmags, tsigns, *config, track=True), dev)
    for label, ms in (*((f"{k}, {K1_LAUNCHES} calls a pass", v) for k, v in k1_turns.items()),
                      *((f"{k}, one call a pass", v) for k, v in run_raw_turns.items()),
                      *((f"{k}, {K1_LAUNCHES} calls a pass", v) for k, v in queued_turns.items()),
                      ("plain version on the card", plain_ms),
                      ("tracked plain version on the card", tplain_ms)):
        print(f"time {label}: {ms:.3f} ms = {MAIN_BATCH / ms * 1e3:.4e} inversions/s "
              f"(HIGH n=4, B={MAIN_BATCH}; {card})")
    print(f"tracked / untracked: kernel {tkernel_ms / kernel_ms:.3f}, run_raw "
          f"{trun_raw_ms / run_raw_ms:.3f}, plain version {tplain_ms / plain_ms:.3f} ({card})")
    t0 = time.perf_counter()
    k1_design_steps(dev, card)
    print(f"host clock: K1's design steps, checks and timings, {time.perf_counter() - t0:.1f} s")

    # -- the roofline path: the probes K5 against their plain version, their
    # rates at full width, and kernel_roofline over K1's emitted body
    t0 = time.perf_counter()
    ubench_err = check_ubench(dev)
    for name in ubench.LAUNCHES:
        ubench.LAUNCHES[name] = 0
    rates, kernelmix_ms = measure_ubench(dev, card)
    rooflines = roofline_path(dev, card, rates, op_times, op_kernel_sass())
    ubench_launches = sum(ubench.LAUNCHES.values())
    assert all(count > 0 for count in ubench.LAUNCHES.values()), \
        f"the roofline path did not launch every mix: {ubench.LAUNCHES}"
    ubench_plain_ms = time_ubench_plain(dev, card)
    print(f"host clock: the roofline path, its check and timings, {time.perf_counter() - t0:.1f} s")

    # -- every kernel's bound, from this run's shapes: bytes over the published
    # memory rate against the 32-bit instructions its function needs over
    # the published issue limit; held against every time measured for it
    k1_bound, k1_by = published_bound(
        k1_bytes(4, MAIN_BATCH, False),
        MAIN_BATCH * rooflines[(4, False)]["nominal_instructions_per_inversion"],
        kernel_ms, plain_ms)
    tk1_bound, tk1_by = published_bound(
        k1_bytes(4, MAIN_BATCH, True),
        MAIN_BATCH * rooflines[(4, True)]["nominal_instructions_per_inversion"],
        tkernel_ms, tplain_ms)
    op_bounds = {name: published_bound(
        24 * KERNEL_ELEMS, roofline._PRIM_NOMINAL_INSTR[function] * KERNEL_ELEMS, *op_times[name])
        for name, function in OP_KERNEL_FUNCTION.items()}
    for name, times in reciprocal_times.items():
        bound, by = published_bound(16 * KERNEL_ELEMS, roofline._PRIM_NOMINAL_INSTR["divide"]
                                    * KERNEL_ELEMS, *times)
        print(f"bound {name} at the High reciprocal (16 B an element): {bound:.3f} ms by {by}; "
              f"measured {times[0]:.3f} ms, torch.div floor {times[2]:.3f} ms ({card})")
    ubench_elems = UBENCH_ROWS * 128
    ubench_bound, ubench_by = published_bound(
        12 * ubench_elems, ubench_elems * UBENCH_KS[2] * UBENCH_C * UBENCH_KERNELMIX_INSTR,
        kernelmix_ms, ubench_plain_ms)

    print(f"e2e ({card}): {json.dumps(e2e)}")
    source = "matrix_inversion_tpu_torch/csrc/fused_inverse.cu"
    print(json.dumps({"kernels": [{
        "name": "fused_inverse",
        "route": "cuda",
        "source": source,
        "replaces": "matrix_inversion_tpu/ops/fused_inverse.py:152",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "fused_inverse_tracked",
        "route": "cuda",
        "source": source,
        "replaces": "matrix_inversion_tpu/ops/fused_inverse.py:152 (track=True)",
        "launches": tracked_launches,
        "max_abs_err": tracked_err,
        "ms": tkernel_ms,
        "plain_ms": tplain_ms,
        "bound_ms": tk1_bound,
        "bound_by": tk1_by,
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"matrix_inversion_tpu_torch/csrc/{source}",
        "replaces": f"matrix_inversion_tpu/ops/pallas_kernels.py:{line}",
        "launches": op_launches[name],
        "max_abs_err": op_err[name],
        "ms": op_times[name][0],
        "plain_ms": op_times[name][1],
        "bound_ms": op_bounds[name][0],
        "bound_by": op_bounds[name][1],
        "library_ms": op_times[name][2],
    } for name, source, line in (
        ("long_division_float", "long_division.cu", 148),
        ("long_division_classic", "long_division.cu", 37),
        ("mul_window", "mul_window.cu", 198),
    )] + [{
        "name": "ubench",
        "route": "cuda",
        "source": "matrix_inversion_tpu_torch/csrc/ubench.cu",
        "replaces": "benchmarks/ubench_vpu.py:124",
        "launches": ubench_launches,
        "max_abs_err": ubench_err,
        "ms": kernelmix_ms,
        "plain_ms": ubench_plain_ms,
        "bound_ms": ubench_bound,
        "bound_by": ubench_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
