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

Then the limb backend (digit arrays, any base; ``limb_paths``): HIGH n=4
over 262,144 matrices on ``backend="limb"`` at base 2, equal bit for bit to
the packed backend's digit path (K1), with and without ``tensorize``, to its
plain version on the card (first 16,384) and to the CPU (first 256); one
``run_raw`` under the profiler (K6 22 times, K7 160, no K1); HIGH's
precision in base 10 (12 digits, 6 integer; "auto" resolves to limb) against
the CPU and its plain version, its error against np.linalg.inv;
``EncryptedMatrixInversion(..., backend="limb")``, whose ``run`` and
``run(simulate=True)`` equal the packed backend's; and the long division K6
and the carry chain K7 alone against their plain versions at 1,048,576
numbers, at HIGH's widths at bases 2, 3 and 10 with zero divisors and
divisors with leading zero digits.  The limb ``run_raw`` is timed in turns
with the packed one and with its plain version, the base-10 one with the
base-2 one, and K6 and K7 beside their bounds.

Then K1 past n = 5, which ``lowering="auto"`` sends to it up to n = 12:
HIGH n = 6..12, untracked and tracked, and LOW n = 10 (the CLI's default
size), built from the start in the background (minutes of nvcc each) and
checked after the other phases, each through ``run_raw`` on a ragged batch
against its plain version on the card and the CPU, with its build time,
registers, spills and block size; the eight recorded outlier matrices
(``benchmarks/results/outliers.json``) through K1 against the CPU and their
recorded errors and flags; the CLI at its default sizes; the ``lowering``,
``fused`` and ``rooflines`` drivers over n = 2..12 (K1 must beat the op-by-op
path at every n it serves), and K1's per-n rows of the ``kernels`` line.
After the limb phase, K6 at a 300-digit divisor, past the 256 digits of its
local-memory window, against its plain version, timed.

After the n=4 main paths, the multi-GPU phase (``parallel/``) over every
visible card: ``make_mesh()``; ``shardmap_check`` (K1 once per card on its
batch shard, 1,048,576 matrices a card, untracked and tracked, each
shard's output on its card, == the one-card K1 bit for bit, flags
included, and the first 64 == the CPU); ``BatchedMatrixInversion`` with
``data_parallel=None`` (one card, however many are visible) and
``True`` (the mesh); one data-parallel ``run_raw`` in the profiler's
trace of the main paths (K1 once on each card, nothing but the shards'
copies, no NCCL kernel); ``data_parallel_inverse`` with digit I/O at HIGH
n=4 (K1 per shard) and n=16 (K2, K4 per shard) == one device; in
subprocesses (this script with ``--worker``), an NCCL group of one rank per
card (``sharded_inverse_with_stats``, its statistic exact, and
``cell_sharded_pipeline`` with the cells split over the ranks) == the CPU,
and two processes (one card each on NCCL, or both on one card on gloo)
whose halves joined == the one-process K1, each loading the K1 the parent
built; then the ``scaling`` driver in a subprocess, its dict printed.  The
other phases run on the first card whatever the count: on a box of four
cards the script checks the same paths and the mesh over four.

Any failure raises.  The last line is one JSON object naming
the device.  Imports nothing of JAX.
"""

import concurrent.futures
import functools
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
    qfloat_matrix_inverse_packed_io,
    qfloat_matrix_inverse_with_overflow,
    qfloat_pivot,
    set_division_impl,
)
from matrix_inversion_tpu_torch.models.inverse import digit_output
from matrix_inversion_tpu_torch.models.marshal import (
    float_matrix_to_mags_and_signs,
    mags_and_signs_to_float_matrix,
    qfloat_and_signs_arrays_to_float_matrix,
)
from matrix_inversion_tpu_torch.ops import (
    cuda_build,
    fused_inverse,
    limb_kernels,
    limbs,
    long_division,
    packed,
)
from matrix_inversion_tpu_torch.parallel import (
    Mesh,
    P,
    cell_sharded_pipeline,
    data_parallel_inverse,
    data_parallel_inverse_fused,
    global_batch_arrays,
    host_local_slice,
    initialize_distributed,
    make_mesh,
    sharded_inverse_with_stats,
)
from matrix_inversion_tpu_torch.parallel.mesh import _all_gather
from matrix_inversion_tpu_torch.runtime import native
from matrix_inversion_tpu_torch.runtime.stream import StreamingInverter
from matrix_inversion_tpu_torch.utils import (
    debug,
    division_steps,
    fused_steps,
    precision,
    roofline,
    run_benchmarks,
    samplers,
    sass,
    ubench,
)
from matrix_inversion_tpu_torch.utils.profiling import device_trace, device_work_by_range
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

# The limb phase: HIGH n=4 on the limb backend at the digit path's batch, its
# plain version on the card on the first LIMB_PLAIN_BATCH matrices (seconds
# of host time a run) and the CPU on the first LIMB_CPU_BATCH; K6 and K7 alone
# at LIMB_KERNEL_NUMBERS numbers.  K6's launches in one HIGH n=4 run_raw are
# its divisions; K7's one a multiply and one an add (the constructor's
# deferred tidy, and the add's tidy and sign in one launch).
LIMB_PLAIN_BATCH = 16_384
LIMB_CPU_BATCH = 256
LIMB_KERNEL_NUMBERS = 1_048_576
LIMB_REPS = 2  # rounds in turns; the checked run is each one's warm-up
K6_LAUNCHES = {4: 22}
K7_LAUNCHES = {4: 160}
K7_TENSORIZE_LAUNCHES = {4: 139}  # tensorize=True groups some tidies
# HIGH's precision in base 10: 12 digits, 6 of them integer (1e6 > 2**20, 1e-6
# ~ 2**-20); no power of two, so "auto" resolves to the limb backend
HIGH_BASE10 = HIGH.replace(n=4, qfloat_base=10, qfloat_len=12, qfloat_ints=6)
# a digit step of K6 (subtract with borrow, the borrow, the add-back, the
# select) and of K7 (carry in, divide, remainder, borrow; twice with sign)
K6_INSTR_PER_STEP = 4
K7_INSTR_PER_DIGIT = 8

# The serving phase: the stream at the main path's batch (6 batches, 3
# tracked) and at the digit path's (3), the e2e benchmark at the main path's
# batch in 4 batches of 2 passes a leg (the JAX benchmark's defaults are 8 and
# 3: cut to keep the phase near a minute), the reference's 10,000-inversion
# sweep, whose first batch is held to the CPU.  The CLI at its default sizes
# runs after K1's check at n = 6..12, which its LOW n=10 needs.
SERVE_BATCHES = 6
SERVE_TRACKED_BATCHES = 3
SERVE_DIGIT_BATCHES = 3
E2E_BATCHES = 4
E2E_REPEATS = 2
STEADY_BATCHES = 16  # the stream once more, after a warm run, on the same batch
STAGE_PASSES = 3
PRECISION_N = 10_000
PRECISION_CHECK = 2048  # precision_benchmark's batch: its first call
CLI_SIZES = (2, 3, 5, 10)
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

# K1 past n = 5, which lowering="auto" sends to it up to n = 12: HIGH
# n = 6..12, untracked and tracked, and LOW n = 10, the CLI's default size.
# A build takes nvcc seconds to six minutes (straight-line bodies of 0.1-1 MB), so
# they start first, in the background, largest first, K1_SIZE_BUILDS at a
# time and at nice BUILD_NICE below the other phases, and are checked after
# them.
K1_SIZES = ([(f"HIGH n={n}", HIGH.replace(n=n), False) for n in range(6, 13)]
            + [(f"HIGH n={n} tracked", HIGH.replace(n=n), True) for n in range(6, 13)]
            + [("LOW n=10", LOW.replace(n=10), False)])
K1_SIZE_BUILDS = 6
BUILD_NICE = 10
K1_CPU_ROWS = 64  # of each size's check, held to the CPU run too
# The drivers: lowering at LOWERING_BATCH, fused and rooflines at
# FUSED_BATCH, over DRIVER_SIZES; the tracked op-by-op path, which has no
# multiply kernel (ROADMAP R3), only at UNROLL_TRACKED_SIZES
DRIVER_SIZES = tuple(range(2, 13))
LOWERING_BATCH = 65_536
FUSED_BATCH = 262_144
UNROLL_TRACKED_SIZES = (2, 3, 4)
OUTLIERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "results",
                        "outliers.json")
# K6 past the 256-digit window of its local-memory form: a 300-digit divisor
# (the window in global scratch), WIDE_NUMBERS numbers
WIDE_DIVISION = (302, 300)
WIDE_NUMBERS = 65_536

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
    for launches in (long_division.LAUNCHES, limb_kernels.LAUNCHES):
        for name in launches:
            launches[name] = 0


def counts():
    return {"fused_inverse": fused_inverse.LAUNCHES,
            "fused_inverse_tracked": fused_inverse.TRACKED_LAUNCHES,
            **long_division.LAUNCHES, **limb_kernels.LAUNCHES}


def timed_s(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def timed_in_turns(fns, dev, rounds=REPS, launches=1, warm_up=True):
    """``{label: median ms of one call}`` of the functions ``fns``, each
    timed once per round (``launches`` calls between two events), ``rounds``
    rounds, after one warm-up call each (none with ``warm_up=False``, for
    functions that have run before): two versions timed so see the same
    clocks."""
    for fn in fns.values() if warm_up else ():
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


def kernels_by_step(dev, steps, key=lambda e: e.name):
    """``{label: {kernel name: launches}}`` (or by ``key`` of the event) of
    the device work of each function in ``steps``, from one profiler trace
    (``device_trace``): each step runs, and every card is synchronized,
    inside a labelled range, and a kernel, copy or fill belongs to the range
    whose host span holds the runtime call that launched it
    (``utils/profiling.py::device_work_by_range``).
    Raises if some device work was launched in no range.  Also prints how
    many kernels the earlier rule (a kernel's device start inside whichever
    range of the label the trace listed last, host or device annotation)
    would have put in no range."""
    with tempfile.TemporaryDirectory() as logdir:
        with device_trace(logdir) as prof:
            for label, fn in steps.items():
                with torch.profiler.record_function(f"step:{label}"):
                    fn()
                    if dev.type == "cuda":
                        for i in range(torch.cuda.device_count()):
                            torch.cuda.synchronize(i)
    events = list(prof.events())
    ran = device_work_by_range(events, list(steps), key=key)
    cpu = torch.autograd.DeviceType.CPU
    named = [e for e in events if e.name.startswith("step:")]
    last = {e.name[5:]: e.time_range for e in named}
    device = [e for e in events if e.device_type != cpu and not e.name.startswith("step:")]
    unplaced = sum(1 for e in device
                   if not any(r.start <= e.time_range.start <= r.end for r in last.values()))
    print(f"profiler: {len(device)} device events, each by the host range of its launching call; "
          f"the trace holds {sum(e.device_type == cpu for e in named)} host ranges and "
          f"{sum(e.device_type != cpu for e in named)} device annotations of the steps, "
          f"{sum(last[e.name[5:]] is e.time_range and e.device_type != cpu for e in named)} of "
          f"them listed last; the device-start rule would have left {unplaced} in no range")
    return ran


def check_launches_under_profiler(dev, inv, mags, signs, tinv, tmags, tsigns, dp,
                                  batch=LARGE_BATCH):
    """One trace over one ``run_raw`` of each n=4 main path, one
    ``PackedQFloat.invert`` as the High circuit calls it (61 bits by 40)
    and one ``run_raw`` of ``dp``, an ``(inverter, mags, signs)`` that runs
    data-parallel over every card.  Each main path's ``run_raw`` must run
    K1 once and nothing else on the device: no transpose, no copy, no fill.
    The reciprocal must launch the division kernel once and no fill for its
    dividend (one cached word, read from its address).  The data-parallel
    ``run_raw`` must run K1 once on each card, and besides the copies of
    the shards between cards nothing else: no NCCL kernel."""
    x = packed.PackedQFloat(
        torch.randint(1, 1 << 40, (batch,), dtype=torch.int64, device=dev), 40, 20)
    x.invert(1, 40, 0)  # the constant word is filled once, here at the latest
    inv.run_raw(mags, signs)
    tinv.run_raw(tmags, tsigns)
    before = long_division.LAUNCHES["long_division_float"]
    got = []
    dp_inv, dp_mags, dp_signs = dp
    dp_inv.run_raw(dp_mags, dp_signs)
    by_card = kernels_by_step(dev, {
        "main path": lambda: inv.run_raw(mags, signs),
        "tracked main path": lambda: tinv.run_raw(tmags, tsigns),
        "reciprocal": lambda: got.append(x.invert(1, 40, 0)),
        "data-parallel run_raw": lambda: dp_inv.run_raw(dp_mags, dp_signs),
    }, key=lambda e: (e.name, e.device_index))
    ran = {}
    for label, work in by_card.items():
        ran[label] = {}
        for (name, _), count in work.items():
            ran[label][name] = ran[label].get(name, 0) + count
    dp_work = by_card["data-parallel run_raw"]
    cards = dp_inv.mesh.size
    k1_cards = sorted(i for (name, i), c in dp_work.items()
                      if "fused_inverse_kernel" in name for _ in range(c))
    assert dev.type != "cuda" or k1_cards == list(range(cards)), \
        f"the data-parallel run_raw ran K1 on cards {k1_cards}, not once on each of {cards}"
    others = {key: c for key, c in dp_work.items() if "fused_inverse_kernel" not in key[0]}
    assert not any("nccl" in name.lower() for name, _ in others), \
        f"the data-parallel run_raw issued a collective: {others}"
    assert cards > 1 or not others, f"the data-parallel run_raw on one card ran {others}"
    assert all("memcpy" in name.lower() for name, _ in others), \
        f"the data-parallel run_raw ran more than K1 and the shards' copies: {others}"
    print(f"data-parallel run_raw on {cards} card(s) under the profiler ran {dp_work}: K1 once "
          "on each card, no collective, nothing but the shards' copies besides")
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


# The multi-GPU phase: K1 once per card at the main path's batch a card, the
# digit circuit per shard at the digit path's batch (K1) and at n=16 on a
# check batch (K2, K4); the NCCL workers' batch (their statistic's sums stay
# below 2**24: 16,384 matrices x 16 cells x 41 digits of at most 1), the
# two-process run's, and each subprocess's time limit.
DP_STATS_BATCH = 16_384
DP_TWO_PROCESS_BATCH = 262_144
DP_TIMEOUT_S = 180


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


def limb_kernel_names(ran):
    """``(K6 launches, K7 launches, K1 launches, other device work)`` in one
    step of a ``kernels_by_step`` trace."""
    k6 = sum(c for name, c in ran.items() if "limbdiv" in name)
    k7 = sum(c for name, c in ran.items() if "limbtidy" in name)
    k1 = sum(c for name, c in ran.items() if "fused_inverse" in name)
    return k6, k7, k1, sum(ran.values()) - k6 - k7 - k1


def well_conditioned(rng, B, n):
    """Normal(0, 1) matrices plus n on the diagonal: inverses of order 1/n,
    condition numbers ~2.6 at the median and ~11 at the 99th percentile for
    n = 4 (a few thousand)."""
    return rng.standard_normal((B, n, n)) + n * np.eye(n)


def smallest_pivot(A):
    """The smallest magnitude of the pivots of A's LU decomposition without
    row exchanges (the circuit's, on A with its rows permuted as
    ``qfloat_pivot`` says): the ratios of its leading minors."""
    minors = [1.0] + [np.linalg.det(A[:k, :k]) for k in range(1, len(A) + 1)]
    return min(abs(minors[k + 1] / minors[k]) for k in range(len(A)))


def k6_inputs(rng, N, d_len, v_len, p, dev, one_row=False):
    """N tidy dividends (or one constant row: a reciprocal's) and divisors
    at base p; a sixteenth of the divisors zero and a sixteenth with their
    top half of digits zero."""
    if one_row:
        v = torch.zeros(d_len, dtype=torch.int32, device=dev)
        v[0] = 1
    else:
        v = torch.from_numpy(rng.randint(0, p, size=(N, d_len)).astype(np.int32)).to(dev)
    d = torch.from_numpy(rng.randint(0, p, size=(N, v_len)).astype(np.int32)).to(dev)
    d[: N // 16] = 0
    d[N // 16: N // 8, : v_len // 2] = 0
    return v, d


def k6_steps(q, v_len, p):
    """Digit steps K6 needs for quotients ``q`` (N, d_len): quotient digit
    i takes min(q_i + 1, p - 1) rounds over JAX's window of min(i + 1,
    v_len + 1) digits."""
    rounds = torch.clamp(q.long() + 1, max=p - 1)
    widths = torch.clamp(torch.arange(1, q.shape[-1] + 1, device=q.device), max=v_len + 1)
    return int((rounds * widths).sum())


def limb_paths(dev, card, batch=DIGIT_BATCH, plain_batch=LIMB_PLAIN_BATCH,
               cpu_batch=LIMB_CPU_BATCH, numbers=LIMB_KERNEL_NUMBERS, reps=LIMB_REPS):
    """The limb backend on the card: HIGH n=4 at base 2 on limb against the
    packed backend (K1) bit for bit, with and without ``tensorize``, against
    its plain version on the card and the CPU, under the profiler (K6 and
    K7, no K1), timed in turns; HIGH's precision in base 10 ("auto" is
    limb) against the CPU and np.linalg.inv; K6 and K7 alone against their
    plain versions at HIGH's widths at bases 2, 3 and 10, timed; and
    ``EncryptedMatrixInversion`` on limb.  Returns the kernels' rows of the
    ``kernels`` line: ``{name: (launches, max_abs_err, ms, plain_ms,
    instructions, bytes)}``."""
    p2 = HIGH.replace(n=4)
    config = config_of(p2)
    sampler = samplers.normal_sampler(4, rng=np.random.RandomState(50))
    M = sampler((batch,))
    inv = BatchedMatrixInversion(p2.replace(backend="limb"), batch, io="digits", device=dev)
    assert inv.backend == "limb"
    d, s = inv.quantize(M)
    out, got = launches_of(lambda: inv.run_raw(d, s))
    expect_launches("limb path HIGH n=4", got, limb_division=K6_LAUNCHES[4],
                    limb_tidy=K7_LAUNCHES[4])
    pinv = BatchedMatrixInversion(p2, batch, backend="packed", io="digits", device=dev)
    pout, pgot = launches_of(lambda: pinv.run_raw(d, s))
    expect_launches("packed digit path HIGH n=4", pgot, fused_inverse=1)
    assert torch.equal(out, pout), "limb path != packed path (K1) at base 2"
    tinv = BatchedMatrixInversion(p2.replace(backend="limb", tensorize=True), batch,
                                  io="digits", device=dev)
    tout, tgot = launches_of(lambda: tinv.run_raw(d, s))
    expect_launches("limb path HIGH n=4 tensorize=True", tgot, limb_division=K6_LAUNCHES[4],
                    limb_tidy=K7_TENSORIZE_LAUNCHES[4])
    assert torch.equal(tout, out), "tensorize=True != tensorize=False on limb"
    sub = BatchedMatrixInversion(p2.replace(backend="limb"), plain_batch, io="digits",
                                 device=dev)
    ds, ss = d[:plain_batch], s[:plain_batch]

    def plain_run():
        with packed.plain_arithmetic():
            return sub.run_raw(ds, ss)

    plain, plain_counts = launches_of(plain_run)
    expect_launches("limb plain version", plain_counts)
    assert torch.equal(plain, out[:plain_batch]), "limb path != its plain version on the card"
    cpu = qfloat_matrix_inverse(d[:cpu_batch].cpu(), s[:cpu_batch].cpu(), *config,
                                backend="limb")
    assert torch.equal(out[:cpu_batch].cpu(), cpu), "limb path != the CPU"
    res = inv.dequantize(out)
    mae = float(np.mean(np.abs(res[:64] - np.linalg.inv(M[:64]))))
    assert np.isfinite(res).all() and mae < 1e-3, f"limb path: mean abs error {mae}"
    ran = kernels_by_step(dev, {"limb run_raw": lambda: inv.run_raw(d, s)})["limb run_raw"]
    k6, k7, k1, other = limb_kernel_names(ran)
    assert dev.type != "cuda" or (k6 == K6_LAUNCHES[4] and k7 == K7_LAUNCHES[4] and k1 == 0), \
        f"the profiler saw K6 {k6}, K7 {k7}, K1 {k1} in a limb run_raw"
    print(f"limb path: HIGH n=4 base 2 B={batch} backend=\"limb\": launches {got} "
          f"(tensorize=True: {tgot}); == the packed path (K1) bit for bit (all), tensorize=True "
          f"== tensorize=False (all), == its plain version on the card (first {plain_batch}, no "
          f"kernel launched), == the CPU (first {cpu_batch}); mean abs error vs np.linalg.inv on "
          f"64 matrices {mae:.3e}; under the profiler one run_raw: K6 {k6}, K7 {k7}, K1 {k1}, "
          f"other device work {other} launches")
    turns = timed_in_turns({"limb run_raw": lambda: inv.run_raw(d, s),
                            "packed digit run_raw": lambda: pinv.run_raw(d, s)}, dev, reps,
                           warm_up=False)
    small = timed_in_turns({"limb run_raw": lambda: sub.run_raw(ds, ss),
                            "plain version": plain_run}, dev, reps, warm_up=False)
    for B, t in ((batch, turns), (plain_batch, small)):
        for label, ms in t.items():
            print(f"time limb path {label}, B={B}: {ms:.3f} ms, median of {reps} rounds in "
                  f"turns (HIGH n=4 base 2; {card})")
    del tinv, tout, plain, pout

    # HIGH's precision in base 10: "auto" resolves to limb
    assert HIGH_BASE10.resolve_backend() == "limb" and not HIGH_BASE10.packed_ok()
    inv10 = BatchedMatrixInversion(HIGH_BASE10, batch, io="digits", device=dev)
    M10 = well_conditioned(np.random.RandomState(51), batch, 4)
    d10, s10 = inv10.quantize(M10)
    out10, got10 = launches_of(lambda: inv10.run_raw(d10, s10))
    expect_launches("limb path HIGH base 10", got10, limb_division=K6_LAUNCHES[4],
                    limb_tidy=K7_LAUNCHES[4])
    cpu10 = qfloat_matrix_inverse(d10[:cpu_batch].cpu(), s10[:cpu_batch].cpu(),
                                  *config_of(HIGH_BASE10))
    assert torch.equal(out10[:cpu_batch].cpu(), cpu10), "base-10 limb path != the CPU"
    res10 = inv10.dequantize(out10)
    err = np.abs(res10 - np.linalg.inv(M10)).reshape(batch, -1)
    # a few of these matrices are near singular (condition numbers up to
    # ~1e4); the error grows with the condition number, as at base 2
    well = np.linalg.cond(M10) <= 10
    big = err.mean(-1) > 1  # precision_benchmark's big-error rate
    # the same matrices at base 2 (HIGH, packed: K1): a tail of large errors
    # on well-conditioned matrices that base 2 shares is the circuit's
    # fixed-point arithmetic, not the limb port's
    d2, s2 = pinv.quantize(M10)
    err2 = np.abs(pinv.dequantize(pinv.run_raw(d2, s2)) - np.linalg.inv(M10)).reshape(batch, -1)
    worst = int(np.flatnonzero(well)[np.argmax(err[well].max(-1))])
    P = qfloat_pivot(d10[worst:worst + 1].cpu(), s10[worst:worst + 1].cpu(),
                     HIGH_BASE10.as_list()).numpy()[0]
    mae10 = float(err[well][:64].mean())
    assert np.isfinite(res10).all() and mae10 < 1e-3, \
        f"base 10: mean abs error {mae10} on 64 matrices of condition <= 10"
    sub10 = BatchedMatrixInversion(HIGH_BASE10, plain_batch, io="digits", device=dev)
    d10s, s10s = d10[:plain_batch], s10[:plain_batch]

    def plain10():
        with packed.plain_arithmetic():
            return sub10.run_raw(d10s, s10s)

    plain10_out = plain10()
    assert torch.equal(plain10_out, out10[:plain_batch]), "base-10 limb != its plain version"
    print(f"limb path: HIGH's precision in base 10 (len 12, ints 6) n=4 B={batch}, backend "
          f"\"auto\" -> limb: launches {got10}; == the CPU (first {cpu_batch}) and its plain "
          f"version on the card (first {plain_batch}); error vs np.linalg.inv: mean abs on the "
          f"first 64 of condition <= 10 {mae10:.3e}; on all {int(well.sum())} of {batch} "
          f"matrices of condition <= 10: max {err[well].max():.3e}, "
          f"largest per-matrix mean {err[well].mean(-1).max():.3e}; on all: mean {err.mean():.3e}, "
          f"max {err.max():.3e} (condition up to {np.linalg.cond(M10).max():.0f}), big-error rate "
          f"(per-matrix mean > 1) {big.mean():.4%}")
    print(f"the same {batch} matrices at base 2 (HIGH n=4, packed digit path, K1): on the "
          f"{int(well.sum())} of condition <= 10: max {err2[well].max():.3e}, largest "
          f"per-matrix mean {err2[well].mean(-1).max():.3e}, mean {err2[well].mean():.3e} (base "
          f"10: mean {err[well].mean():.3e}); on all: max {err2.max():.3e}, big-error rate "
          f"{(err2.mean(-1) > 1).mean():.4%}; base 10's worst matrix of condition <= 10 is "
          f"matrix {worst} of seed 51 (condition {np.linalg.cond(M10[worst]):.2f}, smallest "
          f"pivot of the circuit's LU {smallest_pivot(P @ M10[worst]):.3e}): max error "
          f"base 10 {err[worst].max():.3e}, base 2 {err2[worst].max():.3e}")
    turns10 = timed_in_turns({"base 10 run_raw": lambda: inv10.run_raw(d10, s10),
                              "base 2 run_raw": lambda: inv.run_raw(d, s)}, dev, reps,
                             warm_up=False)
    small10 = timed_in_turns({"base 10 run_raw": lambda: sub10.run_raw(d10s, s10s),
                              "base 10 plain version": plain10}, dev, reps, warm_up=False)
    for B, t in ((batch, turns10), (plain_batch, small10)):
        for label, ms in t.items():
            print(f"time limb path {label}, B={B}: {ms:.3f} ms, median of {reps} rounds in "
                  f"turns (HIGH n=4; {card})")
    print(f"base 10 / base 2 limb run_raw at B={batch}: "
          f"{turns10['base 10 run_raw'] / turns10['base 2 run_raw']:.2f}x ({card})")
    del inv, d, s, out, pinv, sub, inv10, d10, s10, out10, sub10, d2, s2

    # EncryptedMatrixInversion on limb at HIGH's format
    rng = np.random.RandomState(52)
    enc = EncryptedMatrixInversion(4, samplers.normal_sampler(4, rng=rng), 2, 40, 20, True,
                                   backend="limb", device=dev)
    enc_packed = EncryptedMatrixInversion(4, None, 2, 40, 20, True, backend="packed",
                                          device=dev)
    assert enc.backend == "limb"
    for i in range(3):
        A = rng.standard_normal((4, 4)) * 100
        run, run_counts = launches_of(lambda: enc.run(A))
        sim, sim_counts = launches_of(lambda: enc.run(A, simulate=True))
        for label, c in (("run", run_counts), ("simulate", sim_counts)):
            expect_launches(f"EncryptedMatrixInversion limb {label}", c,
                            limb_division=K6_LAUNCHES[4], limb_tidy=K7_LAUNCHES[4])
        assert np.array_equal(run, sim) and np.array_equal(run, enc_packed.run(A)), \
            f"EncryptedMatrixInversion limb matrix {i}: run, simulate and packed disagree"
    print(f"EncryptedMatrixInversion(4, sampler, 2, 40, 20, True, backend=\"limb\"): run "
          f"launches {run_counts}; run == run(simulate=True) == the packed backend's run on 3 "
          "matrices")

    # K6 and K7 alone at HIGH's widths, bases 2, 3, 10, against their plain
    # versions; the main path's shapes timed
    krng = np.random.RandomState(53)
    err6 = err7 = 0
    for p in (2, 3, 10):
        for d_len, v_len, one_row in ((60, 40, False), (61, 40, True)):
            v, dv = k6_inputs(krng, numbers, d_len, v_len, p, dev, one_row)
            q = limb_kernels.limb_division(v, dv, p)
            with packed.plain_arithmetic():
                ref = limbs.base_p_division(v, dv, p)
            err6 = max(err6, max_abs_diff([q], [ref]))
            assert torch.equal(q, ref), f"K6 != plain base {p} ({d_len}, {v_len})"
        for L in (40, 43):
            a = torch.from_numpy(krng.randint(-2 * L * p * p, 2 * L * p * p, size=(numbers, L))
                                 .astype(np.int32)).to(dev)
            for signed in (False, True):
                got_t = limb_kernels.limb_tidy(a, p, signed=signed)
                with packed.plain_arithmetic():
                    ref_t = limbs.tidy_to_sign_mag(a, p) if signed else limbs.base_tidy(a, p)
                got_t, ref_t = (got_t, ref_t) if signed else ((got_t,), (ref_t,))
                err7 = max(err7, max_abs_diff(got_t, ref_t))
                assert all(torch.equal(x, y) for x, y in zip(got_t, ref_t)), \
                    f"K7 != plain base {p} L={L} signed={signed}"
    print(f"K6 == plain at {numbers} numbers, bases 2, 3, 10, (60, 40) digits with a full "
          "dividend and (61, 40) with a reciprocal's, a sixteenth of the divisors zero and a "
          f"sixteenth with their top half zero; K7 == plain at {numbers} numbers, L 40 and 43, "
          f"both modes (tolerance 0; max abs difference K6 {err6}, K7 {err7})")
    v, dv = k6_inputs(krng, numbers, 60, 40, 2, dev)
    q = limb_kernels.limb_division(v, dv, 2)
    ms6 = timed_ms(lambda: limb_kernels.limb_division(v, dv, 2), dev, launches=5)
    with packed.plain_arithmetic():
        plain6 = timed_ms(lambda: limbs.base_p_division(v, dv, 2), dev, passes=1)
    steps = k6_steps(q, 40, 2)
    k6_work = (steps * K6_INSTR_PER_STEP, numbers * (60 + 40 + 60) * 4)
    a = torch.from_numpy(krng.randint(0, 41, size=(numbers, 40)).astype(np.int32)).to(dev)
    ms7 = timed_ms(lambda: limb_kernels.limb_tidy(a, 2, signed=True), dev, launches=5)
    ms7_tidy = timed_ms(lambda: limb_kernels.limb_tidy(a, 2), dev, launches=5)
    with packed.plain_arithmetic():
        plain7 = timed_ms(lambda: limbs.tidy_to_sign_mag(a, 2), dev, passes=1)
    k7_work = (numbers * 40 * K7_INSTR_PER_DIGIT, numbers * (40 * 8 + 4))
    for p, d_len, v_len, one_row in ((3, 61, 40, True), (10, 61, 40, True), (10, 19, 12, False)):
        v, dv = k6_inputs(krng, numbers, d_len, v_len, p, dev, one_row)
        qp = limb_kernels.limb_division(v, dv, p)
        ms = timed_ms(lambda: limb_kernels.limb_division(v, dv, p), dev, launches=5)
        print(f"time K6 base {p} ({d_len}, {v_len}){' reciprocal' if one_row else ''} at "
              f"{numbers} numbers: {ms:.3f} ms, {k6_steps(qp, v_len, p) / numbers:.0f} digit "
              f"steps a number ({card})")
    print(f"time K6 base 2 (60, 40) at {numbers} numbers: {ms6:.3f} ms, plain version "
          f"{plain6:.3f} ms; {steps / numbers:.0f} digit steps a number; K7 base 2 L=40 tidy + "
          f"sign {ms7:.3f} ms, tidy {ms7_tidy:.3f} ms, plain version (tidy then sign) "
          f"{plain7:.3f} ms ({card})")
    # K6's compile-time window (48 digits at HIGH's 40-digit divisor, 16 at
    # base 10's 12) against its run-time window on the same inputs, in turns
    runtime = limb_kernels.RUNTIME_WINDOW
    for p, d_len, v_len in ((2, 60, 40), (10, 19, 12)):
        v, dv = k6_inputs(krng, numbers, d_len, v_len, p, dev)
        q = limb_kernels.limb_division(v, dv, p)
        assert torch.equal(limb_kernels.limb_division(v, dv, p, flags=runtime), q), \
            f"K6's run-time window != its compile-time window, base {p} ({d_len}, {v_len})"
        t = timed_in_turns(
            {"compile-time window": lambda: limb_kernels.limb_division(v, dv, p),
             "run-time window": lambda: limb_kernels.limb_division(v, dv, p, flags=runtime)},
            dev, launches=5)
        print(f"time K6 base {p} ({d_len}, {v_len}) at {numbers} numbers, in turns: "
              f"compile-time window {t['compile-time window']:.3f} ms, run-time window "
              f"{t['run-time window']:.3f} ms (equal quotients; {card})")
    del v, dv, q, a
    return {"limb_division": (got["limb_division"], err6, ms6, plain6, *k6_work),
            "limb_tidy": (got["limb_tidy"], err7, ms7, plain7, *k7_work)}


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
    producer failure raised after two results; the e2e benchmark; the
    reference's error sweep, its first batch == the
    CPU's; and the debug tools on one matrix == the CPU.  Returns the e2e
    dict."""
    p = HIGH.replace(n=4)
    fmt = (p.qfloat_len, p.qfloat_ints, p.qfloat_base)

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


def start_k1_size_builds():
    """Start the nvcc builds of K1_SIZES in the background, largest first,
    K1_SIZE_BUILDS at a time; the pool's threads, and the nvcc processes
    they start, run at nice BUILD_NICE (on Linux a thread's own).  Returns
    the pool and ``{label: future of the build's seconds}``."""
    def lower_priority():
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), BUILD_NICE)

    pool = concurrent.futures.ThreadPoolExecutor(K1_SIZE_BUILDS, initializer=lower_priority)
    order = sorted(K1_SIZES, key=lambda size: (-size[1].n, not size[2]))
    return pool, {label: pool.submit(timed_s, fused_inverse.build_dir, config_of(p) + (track,))
                  for label, p, track in order}


def k1_ptxas(config):
    """``(registers, spill stores, spill loads, stack frame)`` of K1's kernel
    in one config's library, bytes a thread, from ptxas's lines."""
    log = (fused_inverse.build_dir(config) / "nvcc.log").read_text()
    (regs,) = [r for name, r in sass.ptxas_registers(log).items() if "fused_inverse_kernel" in name]
    (line,) = [v for name, v in sass.ptxas_spills(log).items() if "fused_inverse_kernel" in name]
    stack, stores, loads = (int(re.search(rf"(\d+) bytes {what}", line).group(1))
                            for what in ("stack frame", "spill stores", "spill loads"))
    return regs, stores, loads, stack


def k1_sizes(dev, card, build_s, batch=CHECK_BATCH, cpu_rows=K1_CPU_ROWS):
    """K1 at every size of K1_SIZES through ``BatchedMatrixInversion(...,
    io="packed")`` on a ragged batch of x100 matrices, one singular and,
    tracked, one near-singular and one all-zero: exactly one K1 launch a
    ``run_raw`` and nothing else, == its plain version on the card bit for
    bit (flags included), the first ``cpu_rows`` == the CPU run.  Prints each
    size's build seconds, registers, spills and block size; returns
    ``{label: that row}``."""
    rows = {}
    for i, (label, p, track) in enumerate(K1_SIZES):
        n, config = p.n, config_of(p)
        rng = np.random.RandomState(700 + i)
        M = overflowy(rng, batch, n, rows=1) if track else rng.randn(batch, n, n) * 100
        M[5, 2] = M[5, 0] + M[5, 1]  # singular
        inv = BatchedMatrixInversion(p, batch, device=dev, backend="packed", io="packed",
                                     track_overflow=track)
        m, s = inv.quantize(M)
        got, launched = launches_of(lambda: inv.run_raw(m, s))
        expect_launches(f"K1 {label}", launched,
                        **{"fused_inverse_tracked" if track else "fused_inverse": 1})
        ref = fused_inverse.fused_matrix_inverse_reference(m, s, *config, track=track)
        err = max_abs_diff(got, ref)
        assert err == 0, f"K1 {label}: differs from the plain version on the card (max {err})"
        cpu = fused_inverse.fused_matrix_inverse_reference(
            m[:cpu_rows].cpu(), s[:cpu_rows].cpu(), *config, track=track)
        assert all(torch.equal(o[:cpu_rows].cpu(), c) for o, c in zip(got, cpu)), \
            f"K1 {label}: differs from the CPU run"
        if track:
            flags = got[2]
            assert int(flags[0]) == 1 and int(flags[1]) == 1 and not bool(flags.all()), \
                f"K1 {label}: the overflowing matrices were not flagged alone"
        regs, stores, loads, stack = k1_ptxas(config + (track,))
        threads = fused_inverse.block_threads(config + (track,))
        rows[label] = {"launches": 1, "max_abs_err": err, "build_s": build_s[label],
                       "registers": regs, "spill_stores": stores, "spill_loads": loads,
                       "stack": stack, "threads": threads}
        print(f"check K1 {label}: B={batch} (ragged; a singular matrix"
              f"{', a near-singular and an all-zero one, both flagged' if track else ''}): one "
              f"K1 launch a run_raw and nothing else; == plain version on the card bit for bit "
              f"(tolerance 0 on magnitudes, signs{' and flags' if track else ''}), the first "
              f"{cpu_rows} == the CPU run; nvcc {build_s[label]:.1f} s (in the background, "
              f"{K1_SIZE_BUILDS} at a time), {regs} registers, spill stores {stores} and loads "
              f"{loads} bytes, stack frame {stack} bytes a thread; {threads} threads a block "
              f"({card})")
    return rows


def outliers_on_card(dev):
    """The eight recorded HIGH outliers (benchmarks/results/outliers.json)
    through K1, tracked and untracked (``lowering="auto"``): == the CPU run
    bit for bit, one K1 launch each, the flag the recorded one and the mean
    error against np.linalg.inv the recorded one."""
    with open(OUTLIERS) as fh:
        data = json.load(fh)
    count = 0
    for key, entry in sorted(data.items()):
        n = int(key.split("n=")[1])
        p = HIGH.replace(n=n)
        fmt, config = (p.qfloat_len, p.qfloat_ints, p.qfloat_base), config_of(p)
        for o in entry["outliers"]:
            M = np.asarray(o["matrix"])[None]
            mags, signs = float_matrix_to_mags_and_signs(M, *fmt)
            m, s = torch.from_numpy(mags).to(dev), torch.from_numpy(signs).to(dev)
            for fn, kernel in ((qfloat_matrix_inverse_packed_io, "fused_inverse"),
                               (qfloat_matrix_inverse_with_overflow, "fused_inverse_tracked")):
                got, launched = launches_of(lambda: fn(m, s, *config))
                expect_launches(f"outlier {key}", launched, **{kernel: 1})
                cpu = fn(m.cpu(), s.cpu(), *config)
                assert all(torch.equal(g.cpu(), c) for g, c in zip(got, cpu)), \
                    f"outlier {key}: K1 differs from the CPU run"
            # cpu: the tracked run's magnitudes, signs and flag
            inv = mags_and_signs_to_float_matrix(cpu[0].numpy(), cpu[1].numpy(), *fmt)
            assert bool(cpu[2][0]) == o["overflow_flagged"]
            assert float(np.mean(np.abs(inv - np.linalg.inv(M)))) == o["our_error"]
            count += 1
    print(f"outliers: the {count} recorded HIGH matrices (n=2, 5, 10) through K1, tracked and "
          "untracked: == the CPU run bit for bit, one launch each; flags and mean errors == "
          "the recorded ones")


def check_wide_division(dev, card, numbers=WIDE_NUMBERS):
    """K6 at a 300-digit divisor, past the 256 digits its local-memory window
    takes: the form whose window lives in global scratch == the plain
    version on the card, at bases 2 and 3, full dividends and a reciprocal's
    one row, zero divisors and divisors with leading zero digits; timed at
    base 2 beside the plain version."""
    d_len, v_len = WIDE_DIVISION
    rng = np.random.RandomState(300)
    for base in (2, 3):
        d = rng.randint(0, base, size=(numbers, v_len)).astype(np.int32)
        d[:3] = 0
        d[3:9, : v_len // 2] = 0
        d[9, :-1], d[9, -1] = 0, 1
        d = torch.from_numpy(d).to(dev)
        v = torch.from_numpy(rng.randint(0, base, size=(numbers, d_len)).astype(np.int32)).to(dev)
        one = torch.zeros(d_len, dtype=torch.int32, device=dev)
        one[0] = 1
        for label, dividend in (("full dividends", v), ("one row", one)):
            q, launched = launches_of(lambda: limb_kernels.limb_division(dividend, d, base))
            expect_launches(f"K6 wide {label}", launched, limb_division=1)
            ref = limbs.base_p_division_reference(dividend, d, base)
            assert torch.equal(q, ref), f"K6 at {v_len} digits, base {base}, {label}: != plain"
        if base == 2:
            ms = timed_ms(lambda: limb_kernels.limb_division(v, d, 2), dev, passes=3)
            plain_ms = timed_ms(lambda: limbs.base_p_division_reference(v, d, 2), dev, passes=1,
                                warm_up=False)
    print(f"check K6 wide: {d_len} by {v_len} digits (the window in global scratch), {numbers} "
          "numbers, bases 2 and 3, full dividends and one row, zero divisors and leading zero "
          f"digits: == plain version bit for bit; base 2: {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({card})")


def cli_runs():
    """The CLI at its default sizes, plain, ``--simulate`` and ``--batch 4``,
    in three subprocesses at once."""
    for wait in [run_cli(flags) for flags in CLI_RUNS]:
        flags, lines = wait()
        print(f"CLI python -m matrix_inversion_tpu_torch --sizes "
              f"{','.join(map(str, CLI_SIZES))} --preset low {flags}: exit 0; "
              + "; ".join(line.strip() for line in lines if line.startswith("Average")))


def drivers(dev, card, rates):
    """The ``lowering``, ``fused`` and ``rooflines`` drivers over
    DRIVER_SIZES, each dict printed on one line; raises unless K1 is faster
    than the op-by-op path at every n that ``lowering="auto"`` sends to it.
    Returns the ``fused`` dict."""
    t0 = time.perf_counter()
    lowered = run_benchmarks.lowering(DRIVER_SIZES, batch=LOWERING_BATCH, reps=5, repeats=1,
                                      device=dev)
    print(f"lowering ({card}; host clock {time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(lowered)}")
    for n in range(2, fused_inverse.FUSED_MAX_N + 1):
        k1, op = (lowered[f"n={n}/{name}"]["inversions_per_s"] for name in ("fused", "unroll"))
        assert k1 > op, f"n={n}: K1 {k1:.4e} inversions/s is not faster than unroll {op:.4e}"
        print(f"lowering n={n}: K1 {k1:.4e} inversions/s, unroll {op:.4e}, {k1 / op:.1f}x "
              f"(B={LOWERING_BATCH}; {card})")
    t0 = time.perf_counter()
    per_n = run_benchmarks.fused(DRIVER_SIZES, batch=FUSED_BATCH, tracked=True,
                                 unroll_sizes=UNROLL_TRACKED_SIZES,
                                 rates={"u32_kernelmix": rates["u32_kernelmix"]}, device=dev)
    print(f"fused ({card}; host clock {time.perf_counter() - t0:.1f} s): {json.dumps(per_n)}")
    for track in (False, True):
        table = run_benchmarks.rooflines(per_n, track=track)
        print(f"rooflines{' tracked' if track else ''} ({card}): {json.dumps(table)}")
    return per_n


def k1_size_rows(dev, card, checks, per_n, batch=FUSED_BATCH):
    """The ``kernels`` line's rows of K1 at HIGH n = 6..12, untracked and
    tracked: the time from ``fused`` at ``batch``, the plain version's on
    the same matrices (one call), the launches and error of the check, and
    the bound from this run's shapes (``published_bound``, which raises if
    it passes 105% of either time)."""
    rows = []
    for label, p, track in K1_SIZES:
        if not label.startswith("HIGH"):
            continue
        n, config = p.n, config_of(p)
        entry = per_n[f"high/n={n}/{'fused_tracked' if track else 'fused'}"]
        ms = batch / entry["inversions_per_s"] * 1e3
        inv = BatchedMatrixInversion(p, batch, device=dev, backend="packed", io="packed")
        m, s = inv.quantize(np.random.RandomState(0).randn(batch, n, n) * 100)
        plain_ms = timed_ms(lambda: fused_inverse.fused_matrix_inverse_reference(
            m, s, *config, track=track), dev, passes=1, warm_up=False)
        nominal = roofline.kernel_roofline(None, n, "high", None, track)[
            "nominal_instructions_per_inversion"]
        bound, by = published_bound(k1_bytes(n, batch, track), batch * nominal, ms, plain_ms)
        print(f"K1 {label} at B={batch}: {ms:.3f} ms ({batch / ms * 1e3:.4e} inversions/s), plain "
              f"version {plain_ms:.3f} ms, bound {bound:.3f} ms by {by} ({nominal:.0f} nominal "
              f"instructions an inversion), {ms / bound:.1f}x the bound ({card})")
        rows.append({
            "name": f"fused_inverse{'_tracked' if track else ''} HIGH n={n}",
            "route": "cuda",
            "source": "matrix_inversion_tpu_torch/csrc/fused_inverse.cu",
            "replaces": "matrix_inversion_tpu/ops/fused_inverse.py:152"
                        + (" (track=True)" if track else ""),
            "launches": checks[label]["launches"],
            "max_abs_err": checks[label]["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    return rows


def data_parallel_paths(dev, card, per_card=MAIN_BATCH):
    """The data-parallel K1 over every visible card: ``shardmap_check``
    (untracked and tracked, ``per_card`` matrices a card, each shard's
    output on its card before the gather, == the one-card K1 bit for bit,
    flags included, and the first 64 == the CPU; K1 once per card a call);
    ``BatchedMatrixInversion(data_parallel=None)`` runs on one card however
    many are visible, ``data_parallel=True`` runs the mesh (of one card on
    a one-card box; of the named card alone for ``device="cuda:0"``), all
    == the one-card K1.  Returns the
    forced inverter and its inputs, for the profiler's check."""
    mesh = make_mesh()
    count = mesh.size
    print(f"multi-GPU: make_mesh() takes {count} card(s): {mesh}")
    t0 = time.perf_counter()
    check = run_benchmarks.shardmap_check(per_card)
    print(f"shardmap_check ({card}; host clock {time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(check)}")
    for variant in ("untracked", "tracked"):
        assert check[variant]["k1_launches"] == count, f"{variant}: {check[variant]}"
    p = HIGH.replace(n=4)
    batch = per_card * count
    auto = BatchedMatrixInversion(p, batch, backend="packed", io="packed")
    forced = BatchedMatrixInversion(p, batch, backend="packed", io="packed", data_parallel=True)
    named = BatchedMatrixInversion(p, batch, backend="packed", io="packed", data_parallel=True,
                                   device="cuda:0")
    assert auto.mesh is None, f"data_parallel=None picked {auto.mesh}"
    assert forced.mesh.size == count and forced.device == torch.device("cuda", 0)
    assert named.mesh.size == 1 and named.device == torch.device("cuda", 0)
    print(f"BatchedMatrixInversion(HIGH n=4, B={batch}, io='packed'): data_parallel=None runs "
          f"on one card of {count}; data_parallel=True runs the mesh of {forced.mesh.size} "
          "card(s), and on device='cuda:0' the mesh of that card alone")
    M = np.random.RandomState(70).randn(batch, 4, 4) * 100
    mags, signs = forced.quantize(M)
    ref = fused_inverse.fused_matrix_inverse(mags, signs, *config_of(p))
    for label, inv in (("data_parallel=None", auto), ("data_parallel=True", forced),
                       ("data_parallel=True, cuda:0", named)):
        out, got = launches_of(lambda: inv.run_raw(mags, signs))
        expect_launches(label, got, fused_inverse=inv.mesh.size if inv.mesh else 1)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), f"{label} != the one-card K1"
        print(f"{label} run_raw: launches {got}; == the one-card K1 bit for bit")
    return forced, mags, signs


def data_parallel_digit_paths(dev, batch=DIGIT_BATCH, check_batch=CHECK_BATCH):
    """``data_parallel_inverse`` over every card, digit I/O: HIGH n=4 on
    ``batch`` matrices (pack, K1, unpack per shard) and HIGH n=16 on a check
    batch cut to a multiple of the card count (K2 and K4 per shard, under
    the shard's card), each == the one-device ``qfloat_matrix_inverse`` bit
    for bit, launches counted."""
    mesh = make_mesh()
    count = mesh.size
    for n, B, want in ((4, batch, {"fused_inverse": count}),
                       (LARGE_N, check_batch // count * count,
                        {"long_division_float": count * K2_LAUNCHES[LARGE_N],
                         "mul_window": count * K4_LAUNCHES[LARGE_N]})):
        p = HIGH.replace(n=n)
        M = large_n_matrices(np.random.RandomState(71 + n), B, n)
        d, s = (torch.from_numpy(a).to(dev) for a in float_matrix_to_qfloat_arrays(
            M, p.qfloat_len, p.qfloat_ints, p.qfloat_base))
        t0 = time.perf_counter()
        out, got = launches_of(lambda: data_parallel_inverse(p, mesh)(d, s))
        dp_s = time.perf_counter() - t0
        expect_launches(f"data_parallel_inverse HIGH n={n}", got, **want)
        t0 = time.perf_counter()
        ref = qfloat_matrix_inverse(d, s, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
                                    p.true_division, backend="packed")
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        assert torch.equal(out, ref), f"data_parallel_inverse HIGH n={n} != one device"
        print(f"data_parallel_inverse HIGH n={n} B={B} on {count} card(s): launches {got}; == "
              f"the one-device path bit for bit; host clock {dp_s:.2f} s against {one_s:.2f} s "
              "on one device")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _k1_loaded(p, track=False):
    """Seconds to load the HIGH n=4 K1 library that the parent built; raises
    if it is not in ``_build/`` (a worker must not run nvcc)."""
    config = config_of(p) + (track,)
    assert fused_inverse.built(config), f"K1 {config} is not built: the worker would run nvcc"
    t0 = time.perf_counter()
    fused_inverse.build([config])
    return time.perf_counter() - t0


def stats_worker(rank, world, port):
    """One rank of the NCCL group, one card each: its slice of the batch
    through ``sharded_inverse_with_stats`` (the moments all-reduced) and
    its block of cells through ``cell_sharded_pipeline`` (gathered across
    the ranks), each == the CPU run bit for bit, the statistic exactly."""
    t0 = time.perf_counter()
    p = HIGH.replace(n=4)
    M = np.random.RandomState(80).randn(DP_STATS_BATCH, 4, 4) * 100
    digits, signs = float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    # the CPU run, one process, before the group is up
    cpu_out, cpu_stat = sharded_inverse_with_stats(p, make_mesh(1, device="cpu"))(
        torch.from_numpy(digits), torch.from_numpy(signs))
    cpu_s = time.perf_counter() - t0
    card = torch.device("cuda", rank)
    torch.cuda.set_device(card)
    # a group even of one rank (initialize_distributed is a no-op for one
    # process), so that the collectives run through NCCL on the card
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=world, rank=rank)
    load_s = _k1_loaded(p)
    mesh = Mesh([card], ("data",))
    start, size = host_local_slice(DP_STATS_BATCH, mesh)
    d, offset = global_batch_arrays(digits[start:start + size], mesh, P("data", None, None))
    s, _ = global_batch_arrays(signs[start:start + size], mesh, P("data", None))
    assert offset == start
    before = fused_inverse.LAUNCHES
    out, stat = sharded_inverse_with_stats(p, mesh)(d, s)
    per = 16 // world
    cells = slice(rank * per, (rank + 1) * per)
    cell_out = cell_sharded_pipeline(p, Mesh([[card]], ("data", "cell")))(
        torch.from_numpy(digits[:, cells]).to(card), torch.from_numpy(signs[:, cells]).to(card))
    torch.cuda.synchronize()
    launches = fused_inverse.LAUNCHES - before
    assert torch.equal(out.cpu(), cpu_out[start:start + size]), "stats: output != the CPU"
    assert stat.item() == cpu_stat.item(), f"stats: {stat.item()} != the CPU's {cpu_stat.item()}"
    assert torch.equal(cell_out.cpu(), cpu_out), "cell pipeline: output != the CPU"
    assert launches == 2, f"K1 launched {launches} times, not once a program"
    torch.distributed.destroy_process_group()
    print(json.dumps({"worker": "stats", "rank": rank, "world": world, "card": str(card),
                      "k1_load_s": load_s, "launches": launches, "stat": stat.item(),
                      "rows": [start, size], "cells": [cells.start, cells.stop],
                      "cpu_run_s": cpu_s, "total_s": time.perf_counter() - t0}))


def halves_worker(rank, world, port, backend):
    """One of two processes: ``initialize_distributed`` ->
    ``host_local_slice`` -> ``global_batch_arrays`` ->
    ``data_parallel_inverse_fused`` on its half, on its own card (NCCL) or,
    with one card, both on it (gloo, gathering through the host); the
    halves joined == the one-process K1 bit for bit."""
    t0 = time.perf_counter()
    card = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(card)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
    p = HIGH.replace(n=4)
    load_s = _k1_loaded(p)
    M = np.random.RandomState(81).randn(DP_TWO_PROCESS_BATCH, 4, 4) * 100
    mags, signs = float_matrix_to_mags_and_signs(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    mesh = Mesh([card], ("data",))
    start, size = host_local_slice(DP_TWO_PROCESS_BATCH, mesh)
    m, offset = global_batch_arrays(mags[start:start + size], mesh, P("data", None))
    s, _ = global_batch_arrays(signs[start:start + size], mesh, P("data", None))
    before = fused_inverse.LAUNCHES
    out = data_parallel_inverse_fused(p, mesh)(m, s)
    launches = fused_inverse.LAUNCHES - before
    joined = [_all_gather(x, 0) for x in out]
    ref = fused_inverse.fused_matrix_inverse(torch.from_numpy(mags).to(card),
                                             torch.from_numpy(signs).to(card), *config_of(p))
    assert all(torch.equal(a, b) for a, b in zip(joined, ref)), "the halves != the one-process K1"
    assert launches == 1 and offset == start
    torch.distributed.destroy_process_group()
    print(json.dumps({"worker": "halves", "rank": rank, "world": world, "backend": backend,
                      "card": str(card), "k1_load_s": load_s, "launches": launches,
                      "rows": [start, size], "total_s": time.perf_counter() - t0}))


def _start(args):
    """A subprocess of this script or of a module (``-m``) in the repo's
    root; returns a function that waits for it (killing it past
    DP_TIMEOUT_S), raises unless it exited 0 and returns its output."""
    cmd = [sys.executable, *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))

    def wait():
        try:
            out, err = proc.communicate(timeout=DP_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{out}\n{err}"
        return out

    return wait


def distributed_paths(card):
    """The process-group checks in subprocesses, all started at once: an
    NCCL group of one rank per card (``stats_worker``), and two processes on
    NCCL (two or more cards) or on gloo sharing the card
    (``halves_worker``); then the ``scaling`` driver alone in a subprocess
    of its own (its own profiler session).  Any failure, timeout or exit
    other than 0 raises.  Returns the ``scaling`` dict."""
    count = torch.cuda.device_count()
    t0 = time.perf_counter()
    stats_port, halves_port = _free_port(), _free_port()
    backend = "nccl" if count >= 2 else "gloo"
    script = os.path.abspath(__file__)
    waits = [_start([script, "--worker", "stats", str(r), str(count), str(stats_port)])
             for r in range(count)]
    waits += [_start([script, "--worker", "halves", str(r), "2", str(halves_port), backend])
              for r in range(2)]
    for wait in waits:
        print(f"worker: {wait().strip().splitlines()[-1]}")
    print(f"host clock: {count} NCCL rank(s) and 2 {backend} processes, "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    t0 = time.perf_counter()
    out = _start(["-m", "matrix_inversion_tpu_torch.utils.run_benchmarks", "scaling"])()
    scaling = json.loads(out.strip().splitlines()[-1])
    print(f"host clock: the scaling driver in a subprocess, {time.perf_counter() - t0:.1f} s")
    return scaling


def worker(argv):
    """``--worker stats RANK WORLD PORT`` or ``--worker halves RANK WORLD
    PORT BACKEND``: one process of ``distributed_paths``."""
    kind, rank, world, port, *rest = argv
    if kind == "stats":
        stats_worker(int(rank), int(world), port)
    else:
        halves_worker(int(rank), int(world), port, *rest)
    return 0


def main():
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")

    # -- build every kernel of every path from the sources in the checkout,
    # one nvcc per library, all started together; K1 past n = 5 in the
    # background, checked after the other phases
    t0 = time.perf_counter()
    size_pool, size_builds = start_k1_size_builds()
    tracked_configs = [config_of(p) + (True,) for _, p in TRACKED_CHECKS]
    # K1 at the CLI's LOW sizes too, which its subprocesses then load (n=10
    # with K1_SIZES)
    cli_configs = [config_of(LOW.replace(n=n)) for n in CLI_SIZES if n <= 5]
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        fused_build = pool.submit(
            timed_s, fused_inverse.build,
            [config_of(p) for _, p, _ in CHECKS] + tracked_configs + cli_configs)
        op_build = pool.submit(timed_s, long_division.build)
        ubench_build = pool.submit(timed_s, ubench.build)
        steps_build = pool.submit(timed_s, division_steps.build)
        k1_steps_build = pool.submit(timed_s, fused_steps.build)
        native_build = pool.submit(timed_s, native.build)
        limb_build = pool.submit(timed_s, limb_kernels.build)
        fused_s, op_s, ubench_s = fused_build.result(), op_build.result(), ubench_build.result()
        steps_s, k1_steps_s = steps_build.result(), k1_steps_build.result()
        native_s, limb_s = native_build.result(), limb_build.result()
    print(f"build: {len(CHECKS)} fused_inverse + {len(TRACKED_CHECKS)} tracked kernels + "
          f"{len(cli_configs)} at the CLI's sizes up to 5 (LOW) "
          f"from {fused_inverse.CSRC} with nvcc {' '.join(fused_inverse.NVCC_FLAGS)} "
          f"in {fused_s:.1f} s; long_division + mul_window libraries in {op_s:.1f} s; "
          f"the ubench library ({len(ubench.MIXES)} mixes x C in {ubench.CHAIN_COUNTS}) in "
          f"{ubench_s:.1f} s; the division design-steps library in {steps_s:.1f} s; the "
          f"{len({(t, d) for _, t, d, _ in fused_steps.STEPS})} builds of K1's design steps in "
          f"{k1_steps_s:.1f} s; the native marshaller ({native.SOURCE}) with g++ "
          f"{' '.join(cuda_build.HOST_FLAGS)} in {native_s:.1f} s; limb_division + limb_tidy "
          f"libraries and K6's run-time-window build in {limb_s:.1f} s; all in "
          f"{time.perf_counter() - t0:.1f} s, beside the {len(K1_SIZES)} K1 builds past n = 5 "
          f"in the background")
    main_config = config_of(HIGH.replace(n=4))
    for label, c in (("fused_inverse", main_config), ("fused_inverse_tracked", main_config + (True,))):
        print(f"ptxas {label} HIGH n=4: {ptxas_info(fused_inverse.build_dir(c))}")
    for name in ("long_division", "mul_window", "limb_division", "limb_tidy"):
        module = long_division if name in ("long_division", "mul_window") else limb_kernels
        log = (module.build_dir(name) / "nvcc.log").read_text()
        regs = {re.sub(r"^_ZN6sframe|EEvPKm.*$", "", entry): r
                for entry, r in sass.ptxas_registers(log).items()}
        print(f"ptxas {name}, registers: {regs}; spills: {sass.ptxas_spill_lines(log) or 'none'}")
    log = (limb_kernels.build_dir("limb_division", limb_kernels.RUNTIME_WINDOW) / "nvcc.log").read_text()
    print(f"ptxas limb_division with {' '.join(limb_kernels.RUNTIME_WINDOW)}, registers: "
          f"{sass.ptxas_registers(log)}; spills: {sass.ptxas_spill_lines(log) or 'none'}")
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

    # -- multi-GPU: K1 once per card on its batch shard, against the one-card
    # K1 and the CPU; the API's choice of one card or the mesh
    t0 = time.perf_counter()
    dp = data_parallel_paths(dev, card)

    # -- one run_raw of each main path under the profiler: K1 and nothing
    # else; one reciprocal: the division kernel and no fill; one
    # data-parallel run_raw: K1 once per card and no collective
    check_launches_under_profiler(dev, inv, mags, signs, tinv, tmags, tsigns, dp)
    del dp

    # -- multi-GPU, continued: the digit circuit per shard (K1; K2 and K4 at
    # n=16), the process groups in subprocesses, the scaling driver
    data_parallel_digit_paths(dev)
    scaling = distributed_paths(card)
    print(f"host clock: the multi-GPU paths, {time.perf_counter() - t0:.1f} s")

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

    # -- the limb backend: HIGH n=4 at base 2 against K1, base 10, K6 and K7
    # alone, EncryptedMatrixInversion on limb
    t0 = time.perf_counter()
    limb_rows = limb_paths(dev, card)
    check_wide_division(dev, card)
    print(f"host clock: the limb paths, checks and timings, {time.perf_counter() - t0:.1f} s")

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

    # -- K1 past n = 5: the builds started first, each size against its
    # plain version on the card through run_raw, the recorded outliers, the
    # CLI at its default sizes, the lowering, fused and rooflines drivers
    t0 = time.perf_counter()
    build_s = {label: future.result() for label, future in size_builds.items()}
    size_pool.shutdown()
    print(f"host clock: waited {time.perf_counter() - t0:.1f} s for the K1 builds past n = 5 "
          f"({sum(build_s.values()):.1f} s of nvcc in all, the longest "
          f"{max(build_s.values()):.1f} s)")
    t0 = time.perf_counter()
    size_checks = k1_sizes(dev, card, build_s)
    outliers_on_card(dev)
    cli_runs()
    per_n = drivers(dev, card, rates)
    size_rows = k1_size_rows(dev, card, size_checks, per_n)
    print(f"host clock: K1 past n = 5, the outliers, the CLI and the drivers, "
          f"{time.perf_counter() - t0:.1f} s")

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

    limb_bounds = {}
    for name, (_, _, ms, plain, instructions, bytes_moved) in limb_rows.items():
        limb_bounds[name] = published_bound(bytes_moved, instructions, ms, plain)
        at_k5 = max(instructions / rates["u32_kernelmix"], bytes_moved / HBM_BYTES_PER_S) * 1e3
        print(f"bound {name} at {LIMB_KERNEL_NUMBERS} numbers: {limb_bounds[name][0]:.3f} ms by "
              f"{limb_bounds[name][1]} ({instructions / LIMB_KERNEL_NUMBERS:.0f} instructions and "
              f"{bytes_moved / LIMB_KERNEL_NUMBERS:.0f} bytes a number; {at_k5:.3f} ms over "
              f"u32_kernelmix's measured rate {rates['u32_kernelmix']:.4e}); measured {ms:.3f} ms "
              f"= {ms / limb_bounds[name][0]:.2f}x the bound ({card})")

    print(f"e2e ({card}): {json.dumps(e2e)}")
    print(f"scaling ({card}): {json.dumps(scaling)}")
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"matrix_inversion_tpu_torch/csrc/{name}.cu",
        "replaces": f"matrix_inversion_tpu/ops/limbs.py:{line}",
        "launches": limb_rows[name][0],
        "max_abs_err": limb_rows[name][1],
        "ms": limb_rows[name][2],
        "plain_ms": limb_rows[name][3],
        "bound_ms": limb_bounds[name][0],
        "bound_by": limb_bounds[name][1],
        "library_ms": None,
    } for name, line in (("limb_division", 195), ("limb_tidy", 231))] + size_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
