#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the fused whole-inversion kernel, untracked and tracked, from the
sources in ``matrix_inversion_tpu_torch/csrc`` (nvcc, sm_90a, one process
per library, all at once) and holds each against its plain PyTorch version
on the card bit for bit: eight untracked configurations, and five tracked
ones on batches with overflowing matrices (flags included).  Then it
drives the two main paths -- ``BatchedMatrixInversion(HIGH n=4)`` over
1,048,576 matrices, untracked and with ``track_overflow=True``: quantize,
``run_raw`` on CUDA tensors, dequantize -- checks that each ran through its
kernel and agrees with the plain version on the card and on the CPU, and
times each kernel, ``run_raw`` and plain version with CUDA events.  Any
failure raises.  The last line is one JSON object naming the device.
Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from matrix_inversion_tpu_torch import HIGH, LOW, MEDIUM, MEDIUM_PLUS, BatchedMatrixInversion
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops import fused_inverse

MAIN_BATCH = 1_048_576
CHECK_BATCH = 4096 + 17  # ragged: not a multiple of the block size
REPS = 7

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


def ptxas_info(config):
    """ptxas's register and spill lines for one built kernel."""
    log = (fused_inverse.build_dir(config) / "nvcc.log").read_text()
    return " | ".join(
        line.split("ptxas info    : ")[-1].strip()
        for line in log.splitlines()
        if "Used" in line or "spill" in line
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

    # -- build every kernel of both paths from the sources in the checkout
    t0 = time.perf_counter()
    tracked_configs = [config_of(p) + (True,) for _, p in TRACKED_CHECKS]
    fused_inverse.build([config_of(p) for _, p, _ in CHECKS] + tracked_configs)
    print(f"build: {len(CHECKS)} fused_inverse + {len(TRACKED_CHECKS)} tracked kernels "
          f"from {fused_inverse.CSRC} with nvcc {' '.join(fused_inverse.NVCC_FLAGS)} "
          f"in {time.perf_counter() - t0:.1f} s")
    main_config = config_of(HIGH.replace(n=4))
    for label, c in (("fused_inverse", main_config), ("fused_inverse_tracked", main_config + (True,))):
        print(f"ptxas {label} HIGH n=4: {ptxas_info(c)}")

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
    fused_inverse.LAUNCHES = fused_inverse.TRACKED_LAUNCHES = 0
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
    fused_inverse.LAUNCHES = fused_inverse.TRACKED_LAUNCHES = 0
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

    # -- timings (CUDA events, median of REPS after a warm-up)
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
