"""One run of one cell: set-up, the window, the checks, the result line.

The order is the contract's: the driver sets up and measures the window,
reads the memory peak and hands back its sampled answers on the host; then
the process is searched for forbidden modules, the program's state is
freed, and only then the reference works out the sampled answers again
from the same floats, on the same device, in blocks of matrices.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time

import torch

from .. import reference
from . import checks, device as cards, imports, inputs, manifest, program  # noqa: F401


class Forbidden(RuntimeError):
    """The process holds a module that a run may not load."""


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    pool: torch.Tensor  # (pool, batch, n, n) float64 on the host
    marks: list = dataclasses.field(default_factory=list)  # (set-up phase, s from t0)

    def mark(self, phase):
        """Note that the set-up phase ``phase`` ends now."""
        self.marks.append((phase, time.perf_counter() - self.t0))


@dataclasses.dataclass
class Window:
    """What a driver hands back once its window has closed."""

    values: dict  # end-to-end metric name -> value
    attempted: int
    io: str  # the form of the answers: "packed", "digits" or "floats"
    samples: list  # (pool index, answer on the host)
    memory_peak: int
    spans: dict = dataclasses.field(default_factory=dict)  # span name -> [ms, ...]
    summary: object = None  # trace.Summary of the profiled stretch
    notes: list = dataclasses.field(default_factory=list)  # lines for standard error


def _forbid(when):
    found = imports.forbidden_loaded()
    if found:
        raise Forbidden(f"the process holds {', '.join(found)} {when}")


def _module(kind, name, root):
    """``gpubench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "gpubench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fmt_of(config, **changes):
    keys = ("n", "qfloat_len", "qfloat_ints", "qfloat_base", "true_division")
    return {**{k: config[k] for k in keys}, **changes}


def tracked(config):
    """Whether the configuration asks for the overflow flags."""
    return bool(config.get("track_overflow", False))


def compare(cell, pool, samples, io, device, answer_fmt=None):
    """``(mismatched, compared, wrong, flagged)`` of ``samples`` against the
    reference: ``mismatched`` and ``compared`` map each number of
    :data:`~.checks.LIMITS` that the cell compares (``mismatched_cells``, and
    in a tracked configuration ``mismatched_flags``) to what differs and
    what was compared; ``wrong`` counts the answers with anything that
    differs; ``flagged`` is ``(matrices the samples flag, matrices the
    reference flags)``, None untracked.  ``answer_fmt`` replaces the
    configuration's format for the reference's own answers (the control)."""
    fmt = fmt_of(cell.config)
    track = tracked(cell.config)
    names = ["mismatched_cells"] + (["mismatched_flags"] if track else [])
    mismatched, compared = dict.fromkeys(names, 0), dict.fromkeys(names, 0)
    wrong, flagged = 0, [0, 0]
    for k in sorted({k for k, _ in samples}):
        floats = pool[k].to(device)
        want = reference.expected(floats, answer_fmt or fmt, io, cells_fmt=fmt, track=track)
        want = tuple(w.cpu() for w in want) if isinstance(want, tuple) else want.cpu()
        del floats
        for kk, got in samples:
            if kk != k:
                continue
            counts = {"mismatched_cells": checks.mismatched_cells(got, want, io)}
            if track:
                counts["mismatched_flags"] = checks.mismatched_flags(got, want)
                mine = checks.answer_flags(got, want)
                flagged[0] += 0 if mine is None else int(mine.count_nonzero())
                flagged[1] += int(want[2].count_nonzero())
            for name, (bad, total) in counts.items():
                mismatched[name] += bad
                compared[name] += total
            wrong += any(bad for bad, _ in counts.values())
    return mismatched, compared, wrong, tuple(flagged) if track else None


def run(name, seed, seconds, trace, t0, device=None, root=manifest.ROOT, traffic=None):
    """Run the cell ``name`` once; returns ``(result, lines)``: the result
    line's object and the lines for standard error, the checks last.
    ``device`` None looks for the cards the cell asks for and raises
    :class:`~.device.NoCard` without them; ``traffic`` overrides traffic
    parameters (small sizes for tests on the CPU)."""
    marks = [("imports", time.perf_counter() - t0)]
    cell = manifest.cell(name, root)
    cell.traffic.update(traffic or {})
    if device is None:
        device = cards.require_cards(cell.chips)
    cfg, tr = cell.config, cell.traffic
    pool = inputs.float_pool(seed, tr["pool"], tr["batch"], cfg["n"], cfg["sampler"], device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("pool", time.perf_counter() - t0))
    driver = _module("drivers", tr["driver"], root)
    ctx = Context(cell, seed, seconds, bool(trace), device, t0, pool, marks)
    win = driver.run(ctx)

    _forbid("once the window has closed")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    mismatched, compared, wrong, flagged = compare(cell, pool, win.samples, win.io, device)
    lines = ([f"card {cards.name_and_limit()}"] if device.type == "cuda" else []) + win.notes
    lines.append("set-up phases, s from process start: "
                 + ", ".join(f"{phase} {at:.3f}" for phase, at in ctx.marks))
    lines.append(f"compared {len(win.samples)} answers of {win.attempted} in the window, "
                 f"{compared['mismatched_cells']} cells, in {time.perf_counter() - t_check:.3f} s")
    if flagged is not None:
        lines.append(f"overflow flags set in the sampled answers: {flagged[0]} by the program, "
                     f"{flagged[1]} by the reference, of {compared['mismatched_flags']} matrices")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = _module("metrics", m["name"], root).read(cell, win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in win.values]
        if missing:
            raise KeyError(f"the driver {tr['driver']} gives no {missing}")
        metrics = {m["name"]: {"value": win.values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    _forbid("after the check and the metric readers")
    dev = cards.describe(device, cell.chips, win.memory_peak)
    result = {"correct": not any(mismatched.values()) and compared["mismatched_cells"] > 0
              and win.attempted > 0,
              "attempted": win.attempted, "failed": wrong, "metrics": metrics, "device": dev}
    if trace and win.summary is not None:
        dev["busy_s"] = win.summary.busy_s()
        dev["window_s"] = win.summary.window_s
        result["breakdown"] = {"device_ops": win.summary.device_ops(),
                               "idle_gaps": win.summary.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]} for k, v in mismatched.items()}
    lines += [f"check {k} {v} limit {checks.LIMITS[k]}" for k, v in mismatched.items()]
    return result, lines


def main(argv, t0):
    """The command line: prints the lines for standard error, then the
    result as the last line of standard output; returns the exit code."""
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, lines = run(args.workload, args.seed, args.seconds, args.trace, t0)
    except (cards.NoCard, Forbidden) as exc:
        print(f"gpubench: {exc}", file=sys.stderr)
        return 2
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
