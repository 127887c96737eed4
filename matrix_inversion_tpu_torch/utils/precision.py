"""Precision / error benchmark: the reference's 10,000-inversion sweep, and
the compile/run time sweep.

Port of ``matrix_inversion_tpu/utils/precision.py:24-163``.  The reference's
``debug_qfloat_inverse_python`` (qfloat_matrix_inversion.py:883-970) loops N
scalar inversions in Python; here the sweep is a few batched calls of the
digit-I/O circuit on ``device`` (the card by default: K1 for n <= 12, the
op-by-op path beyond; the CPU only when named).  Reports mean |QFloat
inverse - exact inverse| and the big-error rate (share of runs with mean
error > 1), the methodology of the reference's README Table 1.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..config import QFloatParams
from ..models.inverse import qfloat_matrix_inverse
from ..models.marshal import (
    float_matrix_to_qfloat_arrays,
    qfloat_and_signs_arrays_to_float_matrix,
)
from ..runtime.api import _target


def _circuit(p: QFloatParams, n, backend):
    return functools.partial(
        qfloat_matrix_inverse, n=n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base, true_division=p.true_division, tensorize=p.tensorize,
        backend=backend,
    )


def precision_errors(params: QFloatParams, sampler=None, N: int = 10000,
                     batch_size: int = 2048, seed: int = 0, backend: str = None,
                     verbose: bool = False, *, device="cuda"):
    """The per-matrix mean absolute errors of N random inversions against
    ``np.linalg.inv``, in the order they were sampled, float64 ``(N,)``.

    ``sampler(batch_shape) -> (..., n, n)`` defaults to normal(0, 100)
    (reference main.py:119).  Every call of the circuit takes
    ``batch_size`` matrices: the last batch is padded with zero matrices of
    sign 1, as the JAX package pads to reuse its compiled program.
    """
    p = params
    backend = backend or p.resolve_backend()
    device = _target(device, "precision_benchmark")
    rng = np.random.RandomState(seed)
    if sampler is None:
        sampler = lambda b: rng.standard_normal((b, p.n, p.n)) * 100
    fn = _circuit(p, p.n, backend)

    errors = []
    done = 0
    while done < N:
        b = min(batch_size, N - done)
        M = sampler(b)
        digits, signs = float_matrix_to_qfloat_arrays(
            M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )
        if b < batch_size:
            pad = batch_size - b
            digits = np.concatenate([digits, np.zeros((pad,) + digits.shape[1:], digits.dtype)])
            signs = np.concatenate([signs, np.ones((pad,) + signs.shape[1:], signs.dtype)])
        out = fn(torch.from_numpy(digits).to(device), torch.from_numpy(signs).to(device))
        inv = qfloat_and_signs_arrays_to_float_matrix(out.cpu().numpy()[:b], p.qfloat_ints,
                                                      p.qfloat_base)
        exact = np.linalg.inv(M)
        errors.append(np.mean(np.abs(inv - exact), axis=(1, 2)))
        done += b
        if verbose:
            print(f"  {done}/{N}")
    return np.concatenate(errors)


def precision_benchmark(params: QFloatParams, sampler=None, N: int = 10000,
                        batch_size: int = 2048, seed: int = 0, backend: str = None,
                        verbose: bool = False, *, device="cuda"):
    """Run N random inversions, return error statistics (the JAX package's
    dict: ``n``, ``N``, ``mean_error``, ``median_error``, ``max_error``,
    ``big_error_rate_pct``, ``backend``)."""
    backend = backend or params.resolve_backend()
    errors = precision_errors(params, sampler, N, batch_size, seed, backend, verbose,
                              device=device)
    stats = {
        "n": params.n,
        "N": int(N),
        "mean_error": float(np.mean(errors)),
        "median_error": float(np.median(errors)),
        "max_error": float(np.max(errors)),
        "big_error_rate_pct": float(100.0 * np.mean(errors > 1.0)),
        "backend": backend,
    }
    if verbose:
        print("mean error :", stats["mean_error"])
        print("big error rate :" + str(stats["big_error_rate_pct"]) + " %")
    return stats


def _fetched(out, device):
    """Wait for ``out`` on the device and bring one scalar of it to the host."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return int(out.reshape(-1)[0])


def time_benchmark(params: QFloatParams, values_n=(2, 3), filename=None, reps=3,
                   batch_size=1024, backend=None, sampler=None, *, device="cuda"):
    """Wall-clock compile/run sweep (reference qfloat_matrix_inversion.py:
    1148-1188), writing the same style of log file when ``filename`` is
    given.  "compilation" is the first call's time, which builds or loads
    the kernel; each run ends in a synchronize and a scalar fetched to the
    host."""
    device = _target(device, "time_benchmark")

    def write(text):
        if filename:
            with open(filename, "a") as fh:
                fh.write(text)

    if filename:
        with open(filename, "w") as fh:
            fh.truncate(0)

    results = {}
    for n in values_n:
        p = params.replace(n=n)
        be = backend or p.resolve_backend()
        rng = np.random.RandomState(0)
        samp = sampler or (lambda b: rng.standard_normal((b, n, n)) * 100)
        write(f"Benchmark for n = {n}\n")
        times = []
        fn = _circuit(p, n, be)
        M = samp(batch_size)
        digits, signs = float_matrix_to_qfloat_arrays(
            M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )
        digits = torch.from_numpy(digits).to(device)
        signs = torch.from_numpy(signs).to(device)

        t0 = time.time()
        _fetched(fn(digits, signs), device)
        compile_t = time.time() - t0
        write(f"compilation :{compile_t}\n")

        for k in range(reps):
            t0 = time.time()
            _fetched(fn(digits, signs), device)
            run_t = time.time() - t0
            times.append(run_t)
            write(f"{k + 1}\nrunning     :{run_t}\n")
        mean_t = float(np.mean(times))
        write(f"\nmean :{mean_t}\n\n\n")
        results[n] = {
            "compile_s": compile_t,
            "mean_run_s": mean_t,
            "inversions_per_s": batch_size / mean_t,
        }
    return results
