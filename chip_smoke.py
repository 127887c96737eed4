#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the fused whole-inversion kernel from the sources in
``matrix_inversion_tpu_torch/csrc`` (nvcc, sm_90a), holds it bit for bit
against its plain PyTorch version on the card for eight configurations,
drives the main path -- ``BatchedMatrixInversion(HIGH n=4)`` over 1,048,576
matrices: quantize, ``run_raw`` on CUDA tensors, dequantize -- checks that it
ran through the kernel and agrees with the plain version on the card and on
the CPU, and times the kernel, ``run_raw`` and the plain version with CUDA
events.  Any failure raises.  The last line is one JSON object naming the
device.  Imports nothing of JAX.
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


def config_of(p):
    return (p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)


def max_abs_diff(a, b):
    return max(int((x - y).abs().max()) for x, y in zip(a, b))


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

    # -- build every kernel of the path from the sources in the checkout
    t0 = time.perf_counter()
    fused_inverse.build([config_of(p) for _, p, _ in CHECKS])
    print(f"build: {len(CHECKS)} fused_inverse kernels from "
          f"{fused_inverse.CSRC} with nvcc {' '.join(fused_inverse.NVCC_FLAGS)} "
          f"in {time.perf_counter() - t0:.1f} s")

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

    # -- the main path: quantize, run_raw on CUDA tensors, dequantize
    p = HIGH.replace(n=4)
    inv = BatchedMatrixInversion(p, MAIN_BATCH, device="cuda", backend="packed")
    M = np.random.RandomState(0).randn(MAIN_BATCH, 4, 4) * 100
    t0 = time.perf_counter()
    mags, signs = inv.quantize(M)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    fused_inverse.LAUNCHES = 0
    out = inv.run_raw(mags, signs)
    torch.cuda.synchronize()
    launches = fused_inverse.LAUNCHES
    assert launches > 0, "the main path did not launch the fused kernel"
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

    # -- timings (CUDA events, median of REPS after a warm-up)
    cm, cs = mags.t().contiguous(), signs.t().contiguous()
    kernel_ms = timed_ms(lambda: fused_inverse.fused_inverse_cell_major(cm, cs, *config_of(p)))
    run_raw_ms = timed_ms(lambda: inv.run_raw(mags, signs))
    plain_ms = timed_ms(lambda: fused_inverse.fused_matrix_inverse_reference(mags, signs, *config_of(p)))
    for label, ms in (("kernel alone (16, B)", kernel_ms), ("run_raw with transposes", run_raw_ms),
                      ("plain version on the card", plain_ms)):
        print(f"time {label}: {ms:.3f} ms = {MAIN_BATCH / ms * 1e3:.4e} inversions/s "
              f"(HIGH n=4, B={MAIN_BATCH}; {card})")

    print(json.dumps({"kernels": [{
        "name": "fused_inverse",
        "route": "cuda",
        "source": "matrix_inversion_tpu_torch/csrc/fused_inverse.cu",
        "replaces": "matrix_inversion_tpu/ops/fused_inverse.py:152",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
