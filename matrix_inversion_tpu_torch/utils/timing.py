"""Timing helpers (reference qfloat_matrix_inversion.py:747-755).

Port of ``matrix_inversion_tpu/utils/timing.py``.  PyTorch returns from a
CUDA call before the device has finished, so on a CUDA device a timing
pass is bracketed by CUDA events and fenced by synchronizing the closing
event; on the CPU it is the host clock.
"""

from __future__ import annotations

import datetime
import functools
import subprocess
import time

import torch


def measure_time(function, description, verbose=True, *inputs):
    """Run ``function(*inputs)``, print and return (output, seconds)."""
    if verbose:
        print(description + " ...", end="", flush=True)
        print("\r", end="")
    start = time.time()
    output = function(*inputs)
    end = time.time()
    if verbose:
        print(f"|  {description} : {end - start:.2f} s  |")
    return output, end - start


def synchronize(device=None):
    """Wait for the device's queued work (the counterpart of the JAX
    package's ``block_until_ready``); nothing to wait for on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def card_name_and_limit():
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card_state():
    """The first card's SM and memory clocks, power draw and temperature,
    as ``nvidia-smi --query-gpu=clocks.sm,clocks.mem,power.draw,
    temperature.gpu --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _device_of(state):
    """The device of the first tensor in ``state`` (a tensor or a nest of
    tuples and lists), else the CPU."""
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, (tuple, list)):
        for item in state:
            device = _device_of(item)
            if device.type != "cpu":
                return device
    return torch.device("cpu")


def timed_chain(step, fence, state, reps, repeats=3, device=None):
    """Data-dependency-chained throughput timing with dispersion.

    Runs ``repeats`` independent timing passes; each pass chains ``reps``
    calls of ``step(state) -> state`` and ends with ``fence(state)``.  On a
    CUDA device (``device``, or by default where ``state``'s tensors lie)
    the elapsed time of a pass is taken between two CUDA events around the
    chain, and the pass ends by synchronizing the closing event after
    ``fence``; on the CPU it is the host clock.

    Returns ``(elapsed_median_s, stats)`` where ``stats`` carries the
    median/min/max/all elapsed seconds plus run metadata (on CUDA also the
    card's name and power limit under ``card``), so every number records
    its spread and the device it was taken on.
    """
    device = _device_of(state) if device is None else torch.device(device)
    on_cuda = device.type == "cuda"
    elapsed = []
    for _ in range(repeats):
        s = state
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(device):
                start.record()
                for _ in range(reps):
                    s = step(s)
                end.record()
            fence(s)
            end.synchronize()
            elapsed.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.time()
            for _ in range(reps):
                s = step(s)
            fence(s)
            elapsed.append(time.time() - t0)
    med = sorted(elapsed)[len(elapsed) // 2]
    stats = {
        "elapsed_median_s": round(med, 4),
        "elapsed_min_s": round(min(elapsed), 4),
        "elapsed_max_s": round(max(elapsed), 4),
        "elapsed_all_s": [round(e, 4) for e in elapsed],
        "spread_pct": round(100.0 * (max(elapsed) - min(elapsed)) / med, 1),
        "reps": reps,
        "timing_repeats": repeats,
        "date": datetime.date.today().isoformat(),
        "platform": "gpu" if on_cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
    }
    if on_cuda:
        stats["card"] = card_name_and_limit()
    return med, stats


def timed_marginal(step, fence, state, reps, repeats=3, device=None):
    """Marginal (per-rep) cost of ``step``, robust to a fixed cost per pass.

    Times chains of ``reps`` and ``2*reps`` calls (``repeats`` passes each,
    medians) and differences them, cancelling whatever every pass pays
    once (the first launch, the closing synchronize).  Returns
    ``(per_rep_s, stats)``; ``stats`` additionally records the implied
    fixed overhead per pass and both raw chain timings.
    """
    lo, lo_stats = timed_chain(step, fence, state, reps, repeats, device)
    hi, hi_stats = timed_chain(step, fence, state, 2 * reps, repeats, device)
    jitter = max(
        lo_stats["elapsed_max_s"] - lo_stats["elapsed_min_s"],
        hi_stats["elapsed_max_s"] - hi_stats["elapsed_min_s"],
    )
    # the difference only means something when it clears the pass-to-pass
    # jitter; otherwise (tiny per-rep work against a noisy fence) flag it so
    # callers fall back to the raw chain number instead of dividing noise
    reliable = (hi - lo) > 3.0 * jitter
    per_rep = max((hi - lo) / reps, 1e-12)
    stats = {
        "per_rep_s": round(per_rep, 6),
        "fixed_overhead_s": round(lo - reps * per_rep, 4),
        "marginal_reliable": bool(reliable),
        "chain_reps": lo_stats,
        "chain_2reps": hi_stats,
        "reps": reps,
        "timing_repeats": repeats,
        "date": lo_stats["date"],
        "platform": lo_stats["platform"],
        "device_kind": lo_stats["device_kind"],
    }
    if "card" in lo_stats:
        stats["card"] = lo_stats["card"]
    return per_rep, stats
