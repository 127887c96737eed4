#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds every kernel from the sources in ``matrix_inversion_tpu_torch/csrc``
(nvcc, sm_90a, one process per library, all at once): the fused
whole-inversion kernel K1, untracked and tracked, and the op-by-op path's
division kernels K2/K3 and windowed-multiply kernel K4.  Holds each against
its plain PyTorch version on the card bit for bit: K1 on eight untracked
configurations and five tracked ones on batches with overflowing matrices
(flags included); K2 and K3 at the High and Low divide and reciprocal
widths on floor-boundary inputs, zero divisors and a broadcast dividend;
K4 on the circuits' multiply formats.  Then it drives the paths through
``BatchedMatrixInversion``: HIGH n=4 over 1,048,576 matrices, untracked
and with ``track_overflow=True`` (K1); HIGH n=16 over 262,144 matrices,
past K1's n <= 12, on the op-by-op path (K2 and K4), and that path on
4,113 matrices under ``set_division_impl("classic")`` (K3) and tracked;
and HIGH n=4 with ``lowering="unroll"`` (K2 and K4) against K1.  Each path runs with the launch
counts set to 0 just before and read just after, and agrees with its plain
version on the card and on the CPU.  Times each kernel, ``run_raw`` and
plain version with CUDA events.  Any failure raises.  The last line is one
JSON object naming the device.  Imports nothing of JAX.
"""

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from matrix_inversion_tpu_torch import (
    HIGH,
    LOW,
    MEDIUM,
    MEDIUM_PLUS,
    BatchedMatrixInversion,
    set_division_impl,
)
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops import fused_inverse, long_division, packed

MAIN_BATCH = 1_048_576
LARGE_N = 16
LARGE_BATCH = 262_144
CHECK_BATCH = 4096 + 17  # ragged: not a multiple of the block size
REPS = 7
LARGE_REPS = 3  # the n=16 op-by-op run_raw takes seconds
KERNEL_ELEMS = 16_777_216

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
# tests/test_pallas.py:80-83, the High and Low dot products, the multiply
# by a reciprocal and the widened 2x2 intermediate.
MUL_FORMATS = [
    ((40, 16), (40, 16), (40, 16)),
    ((40, 16), (40, 0), (40, 16)),
    ((23, 9), (23, 9), (23, 9)),
    ((23, 9), (23, 9), (21, 21)),
]

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


def timed_ms(fn):
    """Median milliseconds of one call, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def event_ms(fn):
    """Milliseconds of one call, CUDA events; returns (ms, result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


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
    """K2 and K3 == the plain version, tolerance 0; returns each kernel's
    max error."""
    max_err = {"long_division_float": 0, "long_division_classic": 0}
    for i, (label, n_bits, divisor_bits) in enumerate(DIVISION_SHAPES):
        v, d = division_inputs(np.random.RandomState(300 + i), n_bits, divisor_bits, dev)
        k = packed._float_div_chunk_bits(n_bits, divisor_bits)
        ref = packed.packed_long_division_reference(v, d, n_bits)
        one = torch.tensor(1 << (n_bits - 1), dtype=torch.int64, device=dev)
        ref_one = packed.packed_long_division_reference(one, d, n_bits)
        runs = [("long_division_float k=%d" % k,
                 lambda x, y: long_division.batched_long_division_float(x, y, n_bits, k))]
        for bits in (1, 2):
            if n_bits % bits == 0:
                runs.append((f"long_division_classic bits={bits}",
                             lambda x, y, b=bits: long_division.batched_long_division(
                                 x, y, n_bits // b, b)))
        for name, run in runs:
            got, got_one = run(v, d), run(one, d)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = max(max_abs_diff([got], [ref]), max_abs_diff([got_one], [ref_one]))
            kernel = name.split()[0]
            max_err[kernel] = max(max_err[kernel], err)
            assert got.shape == ref.shape and got_one.shape == d.shape
            assert err == 0, f"{name} {label}: kernel differs from the plain version (max {err})"
            print(f"check {name} {label} (n_bits {n_bits}, divisor < 2**{divisor_bits}): "
                  f"{v.numel()} values incl. floor boundaries and zero divisors, and a broadcast "
                  "dividend; kernel == plain version bit for bit (tolerance 0)")
    return max_err


def check_mul_kernel(dev):
    """K4 == the plain version, tolerance 0; returns the max error."""
    max_err = 0
    for i, ((al, ai), (bl, bi), (nl, ni)) in enumerate(MUL_FORMATS):
        rng = np.random.RandomState(400 + i)
        a = rng.randint(0, 1 << 62, size=CHECK_BATCH, dtype=np.int64) & ((1 << al) - 1)
        b = rng.randint(0, 1 << 62, size=CHECK_BATCH, dtype=np.int64) & ((1 << bl) - 1)
        a[:2], b[2:4] = 0, (1 << bl) - 1
        a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        consts = packed.mul_window_consts(al, ai, bl, bi, nl, ni, 1)
        got = long_division.batched_mul_window(a, b, consts, nl)
        ref = packed.mul_window_packed(a, al, ai, b, bl, bi, nl, ni, 1)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err = max_abs_diff([got], [ref])
        max_err = max(max_err, err)
        assert err == 0, f"mul_window {(al, ai)}x{(bl, bi)}->{(nl, ni)}: kernel differs (max {err})"
        print(f"check mul_window (len, ints) {(al, ai)} x {(bl, bi)} -> {(nl, ni)}: "
              f"B={CHECK_BATCH}, kernel == plain version bit for bit (tolerance 0)")
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
    inv = BatchedMatrixInversion(p, batch, device=dev)
    M = large_n_matrices(np.random.RandomState(16), batch, LARGE_N)
    mags, signs = inv.quantize(M)
    signs = with_sign0_cells(signs, 17)
    reset_counts()
    out = inv.run_raw(mags, signs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    main_counts = counts()
    assert main_counts["long_division_float"] > 0, "the n=16 path did not launch K2"
    assert main_counts["mul_window"] > 0, "the n=16 path did not launch K4"
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
    cinv = BatchedMatrixInversion(p, check_batch, device=dev)
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

    tinv = BatchedMatrixInversion(p, check_batch, device=dev, track_overflow=True)
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
    uinv = BatchedMatrixInversion(p4.replace(lowering="unroll"), check_batch, device=dev)
    um, us = uinv.quantize(np.random.RandomState(19).randn(check_batch, 4, 4) * 100)
    us = with_sign0_cells(us, 20)
    reset_counts()
    uout = uinv.run_raw(um, us)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    unroll_counts = counts()
    assert unroll_counts["long_division_float"] > 0 and unroll_counts["mul_window"] > 0
    assert unroll_counts["fused_inverse"] == 0
    k1 = fused_inverse.fused_matrix_inverse(um, us, *config_of(p4))
    assert all(torch.equal(a, b) for a, b in zip(uout, k1)), "HIGH n=4: op-by-op path != K1"
    print(f"cross-check HIGH n=4 B={check_batch}: lowering=\"unroll\" (launches "
          f"{unroll_counts}) == K1 bit for bit")

    # run_raw with the kernels and inside plain_arithmetic(), in turns
    # (kernels first, then plain first, ...) after the warm checked runs
    def with_kernels():
        return event_ms(lambda: inv.run_raw(mags, signs))[0]

    def plain():
        with packed.plain_arithmetic():
            return event_ms(lambda: inv.run_raw(mags, signs))[0]

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


def time_op_kernels(dev, card, elems=KERNEL_ELEMS):
    """K2, K3 and K4 alone and their plain versions at the High divide
    shape and the High dot-product multiply, median of REPS; returns
    {name: (ms, plain_ms)}."""
    g = torch.Generator(device=dev).manual_seed(21)
    v = torch.randint(0, 1 << 60, (elems,), dtype=torch.int64, device=dev, generator=g)
    d = torch.randint(1, 1 << 40, (elems,), dtype=torch.int64, device=dev, generator=g)
    a = torch.randint(0, 1 << 40, (elems,), dtype=torch.int64, device=dev, generator=g)
    b = torch.randint(0, 1 << 40, (elems,), dtype=torch.int64, device=dev, generator=g)
    consts = packed.mul_window_consts(40, 20, 40, 20, 40, 20, 1)
    div_plain = timed_ms(lambda: packed.packed_long_division_reference(v, d, 60))
    times = {
        "long_division_float": (
            timed_ms(lambda: long_division.batched_long_division_float(v, d, 60, 15)), div_plain),
        "long_division_classic": (
            timed_ms(lambda: long_division.batched_long_division(v, d, 60, 1)), div_plain),
        "mul_window": (
            timed_ms(lambda: long_division.batched_mul_window(a, b, consts, 40)),
            timed_ms(lambda: packed.mul_window_packed(a, 40, 20, b, 40, 20, 40, 20, 1)[0])),
    }
    trunc_ms = timed_ms(lambda: packed.mul_trunc_packed(a, 40, 20, b, 40, 20, 40, 20, 1))
    for name, (ms, plain) in times.items():
        print(f"time {name} alone: {ms:.3f} ms, plain version {plain:.3f} ms, on {elems} "
              f"elements (High {'divide n_bits 60, divisor < 2**40' if 'division' in name else 'dot product (40, 20) x (40, 20) -> (40, 20)'}; {card})")
    print(f"time mul_trunc_packed (the CPU route's multiply) on the card: {trunc_ms:.3f} ms "
          f"on {elems} elements ({card})")
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")

    # -- build every kernel of every path from the sources in the checkout,
    # one nvcc per library, all started together
    t0 = time.perf_counter()
    tracked_configs = [config_of(p) + (True,) for _, p in TRACKED_CHECKS]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        fused_build = pool.submit(
            timed_s, fused_inverse.build, [config_of(p) for _, p, _ in CHECKS] + tracked_configs)
        op_build = pool.submit(timed_s, long_division.build)
        fused_s, op_s = fused_build.result(), op_build.result()
    print(f"build: {len(CHECKS)} fused_inverse + {len(TRACKED_CHECKS)} tracked kernels "
          f"from {fused_inverse.CSRC} with nvcc {' '.join(fused_inverse.NVCC_FLAGS)} "
          f"in {fused_s:.1f} s; long_division + mul_window libraries in {op_s:.1f} s; "
          f"all in {time.perf_counter() - t0:.1f} s")
    main_config = config_of(HIGH.replace(n=4))
    for label, c in (("fused_inverse", main_config), ("fused_inverse_tracked", main_config + (True,))):
        print(f"ptxas {label} HIGH n=4: {ptxas_info(fused_inverse.build_dir(c))}")
    for name in ("long_division", "mul_window"):
        print(f"ptxas {name}: {ptxas_info(long_division.build_dir(name))}")

    # -- kernel vs plain version on the card, bit for bit
    max_err = 0
    for i, (label, p, singular) in enumerate(CHECKS):
        rng = np.random.RandomState(100 + i)
        M = rng.randn(CHECK_BATCH, p.n, p.n) * (1 if singular else 100)
        if singular:
            M[:, 2, :] = M[:, 0, :] + M[:, 1, :]  # rank-deficient
        m, s = float_matrix_to_mags_and_signs(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
        m, s = torch.from_numpy(m).to(dev), torch.from_numpy(s).to(dev)
        got = fused_inverse.fused_matrix_inverse(m, s, *config_of(p))
        ref = fused_inverse.fused_matrix_inverse_reference(m, s, *config_of(p))
        torch.cuda.synchronize()
        err = max_abs_diff(got, ref)
        max_err = max(max_err, err)
        assert err == 0, f"{label}: kernel differs from the plain version (max {err})"
        print(f"check {label}: B={CHECK_BATCH}, kernel == plain version bit for bit "
              "(tolerance 0 on magnitudes and signs)")

    # -- tracked kernel vs tracked plain version on the card, bit for bit
    tracked_err = 0
    for i, (label, p) in enumerate(TRACKED_CHECKS):
        M = overflowy(np.random.RandomState(200 + i), CHECK_BATCH, p.n, rows=1)
        m, s = float_matrix_to_mags_and_signs(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
        m, s = torch.from_numpy(m).to(dev), torch.from_numpy(s).to(dev)
        got = fused_inverse.fused_matrix_inverse(m, s, *config_of(p), track=True)
        ref = fused_inverse.fused_matrix_inverse_reference(m, s, *config_of(p), track=True)
        torch.cuda.synchronize()
        err = max_abs_diff(got, ref)
        tracked_err = max(tracked_err, err)
        assert err == 0, f"tracked {label}: kernel differs from the plain version (max {err})"
        flagged = int(got[2].sum())
        assert got[2].dtype == torch.int32 and 0 < flagged < CHECK_BATCH, \
            f"tracked {label}: {flagged} flagged of {CHECK_BATCH}"
        assert int(got[2][0]) == 1 and int(got[2][1]) == 1, f"tracked {label}: overflow not flagged"
        print(f"check tracked {label}: B={CHECK_BATCH}, {flagged} flagged; kernel == plain "
              "version bit for bit (tolerance 0 on magnitudes, signs and flags)")

    # -- the main path: quantize, run_raw on CUDA tensors, dequantize
    p = HIGH.replace(n=4)
    inv = BatchedMatrixInversion(p, MAIN_BATCH, device="cuda", backend="packed")
    M = np.random.RandomState(0).randn(MAIN_BATCH, 4, 4) * 100
    t0 = time.perf_counter()
    mags, signs = inv.quantize(M)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    reset_counts()
    out = inv.run_raw(mags, signs)
    torch.cuda.synchronize()
    launches = fused_inverse.LAUNCHES
    assert launches > 0, "the main path did not launch the fused kernel"
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
    tinv = BatchedMatrixInversion(p, MAIN_BATCH, device="cuda", backend="packed",
                                  track_overflow=True)
    rows = 1024
    TM = overflowy(np.random.RandomState(0), MAIN_BATCH, 4, rows)
    tmags, tsigns = tinv.quantize(TM)
    torch.cuda.synchronize()
    reset_counts()
    tout = tinv.run_raw(tmags, tsigns)
    torch.cuda.synchronize()
    tracked_launches = fused_inverse.TRACKED_LAUNCHES
    assert tracked_launches > 0, "the tracked main path did not launch the tracked kernel"
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

    # -- the op-by-op path's kernels vs their plain versions on the card
    op_err = {**check_division_kernels(dev), "mul_window": check_mul_kernel(dev)}

    # -- the op-by-op paths: HIGH n=16 (K2), classic (K3), K4, tracked, n=4
    t0 = time.perf_counter()
    op_launches = large_n_paths(dev, card)
    print(f"host clock: the op-by-op paths, checks and timings, {time.perf_counter() - t0:.1f} s")

    # -- timings (CUDA events, median of REPS after a warm-up)
    op_times = time_op_kernels(dev, card)
    cm, cs = mags.t().contiguous(), signs.t().contiguous()
    kernel_ms = timed_ms(lambda: fused_inverse.fused_inverse_cell_major(cm, cs, *config_of(p)))
    run_raw_ms = timed_ms(lambda: inv.run_raw(mags, signs))
    plain_ms = timed_ms(lambda: fused_inverse.fused_matrix_inverse_reference(mags, signs, *config_of(p)))
    tcm, tcs = tmags.t().contiguous(), tsigns.t().contiguous()
    tkernel_ms = timed_ms(lambda: fused_inverse.fused_inverse_cell_major(
        tcm, tcs, *config_of(p), track=True))
    trun_raw_ms = timed_ms(lambda: tinv.run_raw(tmags, tsigns))
    tplain_ms = timed_ms(lambda: fused_inverse.fused_matrix_inverse_reference(
        tmags, tsigns, *config_of(p), track=True))
    for label, ms in (("kernel alone (16, B)", kernel_ms), ("run_raw with transposes", run_raw_ms),
                      ("plain version on the card", plain_ms),
                      ("tracked kernel alone (16, B)", tkernel_ms),
                      ("tracked run_raw with transposes", trun_raw_ms),
                      ("tracked plain version on the card", tplain_ms)):
        print(f"time {label}: {ms:.3f} ms = {MAIN_BATCH / ms * 1e3:.4e} inversions/s "
              f"(HIGH n=4, B={MAIN_BATCH}; {card})")
    print(f"tracked / untracked: kernel {tkernel_ms / kernel_ms:.3f}, run_raw "
          f"{trun_raw_ms / run_raw_ms:.3f}, plain version {tplain_ms / plain_ms:.3f} ({card})")

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
    }, {
        "name": "fused_inverse_tracked",
        "route": "cuda",
        "source": source,
        "replaces": "matrix_inversion_tpu/ops/fused_inverse.py:152 (track=True)",
        "launches": tracked_launches,
        "max_abs_err": tracked_err,
        "ms": tkernel_ms,
        "plain_ms": tplain_ms,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"matrix_inversion_tpu_torch/csrc/{source}",
        "replaces": f"matrix_inversion_tpu/ops/pallas_kernels.py:{line}",
        "launches": op_launches[name],
        "max_abs_err": op_err[name],
        "ms": op_times[name][0],
        "plain_ms": op_times[name][1],
    } for name, source, line in (
        ("long_division_float", "long_division.cu", 148),
        ("long_division_classic", "long_division.cu", 37),
        ("mul_window", "mul_window.cu", 198),
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
