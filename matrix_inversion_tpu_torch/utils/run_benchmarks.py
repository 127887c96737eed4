"""Benchmark runners: the precision table, throughput, and end-to-end
float-in, float-out throughput with and without the pipeline.

Port of the ``precision``, ``throughput`` and ``e2e`` subcommands of
``benchmarks/run_benchmarks.py:35-98,268-431`` as functions that return
their dicts and write no file (``benchmarks/results/`` holds the TPU's
records).  Each runs on ``device``, the card by default; the CPU runs only
for a caller who names it, and its numbers are host numbers.  ``scaling``
waits for multi-GPU batching (ROADMAP queue 1, item 10).

    python -m matrix_inversion_tpu_torch.utils.run_benchmarks e2e [--batch 262144]

prints the dict as one JSON line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import statistics
import time

import numpy as np
import torch

from ..config import PRESETS
from ..runtime import native
from ..runtime.api import BatchedMatrixInversion, _target
from ..runtime.stream import StreamingInverter
from .precision import precision_benchmark


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """Host seconds of ``fn()``, which ends in a synchronize."""
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def precision(N=10000, sizes=(2, 3, 4, 5, 10), presets=("low", "medium", "medium+", "high"),
              batch=4096, *, device="cuda"):
    """The reference's README Table 1: mean error and big-error rate per
    preset and size (``benchmarks/run_benchmarks.py:35-60``)."""
    table = {}
    for preset_name in presets:
        for n in sizes:
            p = PRESETS[preset_name].replace(n=n)
            t0 = time.perf_counter()
            stats = precision_benchmark(p, N=N, batch_size=min(N, batch), seed=0, device=device)
            stats["wall_s"] = time.perf_counter() - t0
            table[f"{preset_name}/n={n}"] = stats
            print(preset_name, n, stats, flush=True)
    return table


def throughput(batch=262144, reps=10, *, device="cuda"):
    """Device inversions/s of packed-I/O ``run_raw`` chained ``reps`` times,
    per preset and size (``benchmarks/run_benchmarks.py:63-98``)."""
    device = _target(device, "throughput")
    results = {}
    for preset_name, n in [("low", 2), ("medium", 3), ("high", 4), ("high", 5)]:
        p = PRESETS[preset_name].replace(n=n)
        inv = BatchedMatrixInversion(p, batch, backend="packed", io="packed", device=device)
        M = np.random.RandomState(0).randn(batch, n, n) * 100
        m, s = inv.quantize(M)
        _timed(lambda: inv.run_raw(m, s), device)  # build or load, warm
        chain = [m, s]

        def run():
            for _ in range(reps):
                chain[:] = inv.run_raw(*chain)

        elapsed = _timed(run, device)
        results[f"{preset_name}/n={n}"] = {
            "inversions_per_s": batch * reps / elapsed,
            "batch": batch,
            "reps": reps,
            "elapsed_s": elapsed,
        }
        print(results[f"{preset_name}/n={n}"], flush=True)
    return results


def e2e(preset="high", n=4, batch=262144, nbatches=8, depth=2, repeats=3, finish_workers=2,
        native_only=False, *, device="cuda"):
    """Sustained end-to-end throughput, quantize -> invert -> dequantize
    (``benchmarks/run_benchmarks.py:268-409``), with its keys.

    Legs, each timed in ``repeats`` passes (every pass is kept under
    ``..._all``, and the median beside it): the device alone (``run_raw``
    chained ``nbatches`` times); per marshalling route ("native", the C++
    library, and "numpy", the closed form, with the library switched off
    for the leg): the host quantize and dequantize of one batch, the serial
    estimate without transfers (host stages + device time), the serial
    pipeline measured (``inv.run`` batch after batch: transfers included)
    and the streamed pipeline (``StreamingInverter``)."""
    device = _target(device, "e2e")
    p = PRESETS[preset].replace(n=n)
    inv = BatchedMatrixInversion(p, batch, backend="packed", io="packed", device=device)
    M = np.random.RandomState(0).randn(batch, n, n) * 100
    results = {
        "config": f"{preset}/n={n}",
        "batch": batch,
        "n_batches_streamed": nbatches,
        "date": datetime.date.today().isoformat(),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "methodology_note": (
            "serial_measured = the same quantize->H2D->run->D2H->dequantize stages "
            "the streamed path runs, executed sequentially (inv.run, pageable "
            "transfers included, measured); serial_est_no_transfer = host phases "
            "+ device compute only; streamed-vs-serial_measured is the overlap A/B."
        ),
    }

    # device-only reference rate (chained run_raw)
    m, s = inv.quantize(M)
    out = inv.run_raw(m, s)
    _sync(device)
    chain = [m, s]

    def chained():
        for _ in range(nbatches):
            chain[:] = inv.run_raw(*chain)

    dev_times = [_timed(chained, device) for _ in range(repeats)]
    dev_elapsed = statistics.median(dev_times)
    results["device_only_inversions_per_s"] = batch * nbatches / dev_elapsed
    results["device_only_inversions_per_s_all"] = [batch * nbatches / t for t in dev_times]
    host_out = [o.cpu().numpy() for o in out]

    for label in ("native",) if native_only else ("native", "numpy"):
        saved = native._LIB
        if label == "numpy":
            native._LIB = False
        try:
            inv._host_quantize(M)  # the native library's build or load is not timed
            tq = [_timed(lambda: inv._host_quantize(M), device) for _ in range(repeats)]
            tdq = [_timed(lambda: inv._host_dequantize(host_out), device)
                   for _ in range(repeats)]
            results[f"{label}/quantize_s_per_batch"] = statistics.median(tq)
            results[f"{label}/quantize_s_per_batch_all"] = tq
            results[f"{label}/dequantize_s_per_batch"] = statistics.median(tdq)
            results[f"{label}/dequantize_s_per_batch_all"] = tdq
            results[f"{label}/serial_est_no_transfer_inversions_per_s"] = batch / (
                statistics.median(tq) + dev_elapsed / nbatches + statistics.median(tdq))

            def serial():
                count = sum(inv.run(M).shape[0] for _ in range(nbatches))
                assert count == batch * nbatches

            serial_rates = [batch * nbatches / _timed(serial, device) for _ in range(repeats)]
            results[f"{label}/serial_measured_inversions_per_s"] = statistics.median(serial_rates)
            results[f"{label}/serial_measured_inversions_per_s_all"] = serial_rates

            def streamed():
                stream = StreamingInverter(inv, depth=depth, finish_workers=finish_workers)
                count = sum(r.shape[0] for r in stream.run([M] * nbatches))
                assert count == batch * nbatches

            rates = [batch * nbatches / _timed(streamed, device) for _ in range(repeats)]
            results[f"{label}/streamed_inversions_per_s"] = statistics.median(rates)
            results[f"{label}/streamed_inversions_per_s_all"] = rates
        finally:
            native._LIB = saved
        print(label, {k: v for k, v in results.items() if k.startswith(label)}, flush=True)

    dev = results["device_only_inversions_per_s"]
    best = results.get("native/streamed_inversions_per_s",
                       results.get("numpy/streamed_inversions_per_s", 0))
    results["streamed_fraction_of_device_rate"] = best / dev
    for label in ("native", "numpy"):
        st = results.get(f"{label}/streamed_inversions_per_s")
        se = results.get(f"{label}/serial_measured_inversions_per_s")
        if st and se:
            results[f"{label}/streamed_over_serial_measured"] = st / se
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("precision")
    pr.add_argument("--N", type=int, default=10000)
    pr.add_argument("--sizes", default="2,3,4,5,10")
    pr.add_argument("--presets", default="low,medium,medium+,high")
    pr.add_argument("--batch", type=int, default=4096)
    th = sub.add_parser("throughput")
    th.add_argument("--batch", type=int, default=262144)
    th.add_argument("--reps", type=int, default=10)
    ee = sub.add_parser("e2e")
    ee.add_argument("--n", type=int, default=4)
    ee.add_argument("--preset", default="high")
    ee.add_argument("--batch", type=int, default=262144)
    ee.add_argument("--nbatches", type=int, default=8)
    ee.add_argument("--depth", type=int, default=2)
    ee.add_argument("--repeats", type=int, default=3)
    ee.add_argument("--finish-workers", type=int, default=2)
    ee.add_argument("--native-only", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "precision":
        out = precision(args.N, [int(s) for s in args.sizes.split(",")],
                        args.presets.split(","), args.batch, device=args.device)
    elif args.cmd == "throughput":
        out = throughput(args.batch, args.reps, device=args.device)
    else:
        out = e2e(args.preset, args.n, args.batch, args.nbatches, args.depth, args.repeats,
                  args.finish_workers, args.native_only, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
