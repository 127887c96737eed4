"""One caller in a closed loop on device-resident inputs.

Set-up quantizes the pool's float batches with the program
(``BatchedMatrixInversion.quantize``: packed or digit I/O, as the traffic's
``io`` says) and warms up ``warm_calls`` calls.  The window then calls
``run_raw`` on the pool's batches in turn, waiting for each call's outputs
(``synchronize``) before the next call, until a call's outputs are ready
after the window's close.  The rate counts every call the loop made, that
last one too, over the time from the window's start to its outputs: all the
work over all the time the loop ran, so no fraction of a call is lost and a
stall that the close cuts shows.  ``call_p95_ms`` and ``run_raw_host`` take
the calls whose outputs were ready inside the window.

Traffic parameters: ``io``, ``batch``, ``pool``, ``warm_calls``,
``keep_outputs`` (answers sampled from the window for the check),
``trace_seconds`` (the profiled stretch at the window's start, in traced runs
only).

Spans: ``run_raw_host`` (ms from the call to its return, the calls after the
profiled stretch); in the stretch the profiler sees ``gpubench.run_raw`` and
``gpubench.sync`` around each call's two parts.
"""

from __future__ import annotations

import contextlib
import time

from gpubench.harness import device as cards, program, stats, trace
from gpubench.harness.checks import Reservoir
from gpubench.harness.runner import Window


def answers(traffic):
    """The form of the answers that a run's check compares."""
    return traffic["io"]


def run(ctx):
    import torch

    tr, dev = ctx.cell.traffic, ctx.device
    inv = program.inverter(ctx.cell.config, tr["batch"], tr["io"], dev)
    args = [inv.quantize(batch.numpy()) for batch in ctx.pool]
    program.synchronize(dev)
    ctx.mark("quantize")
    for i in range(tr["warm_calls"]):
        inv.run_raw(*args[i % len(args)])
        program.synchronize(dev)
    ctx.mark("warm")
    session = trace.Session(dev.type == "cuda") if ctx.trace else None

    def call(k, traced):
        spans = trace.span if traced else (lambda name: contextlib.nullcontext())
        a = time.perf_counter()
        with spans("run_raw"):
            out = inv.run_raw(*args[k])
        b = time.perf_counter()
        with spans("sync"):
            program.synchronize(dev)
        return out, a, b, time.perf_counter()

    kept = Reservoir(tr["keep_outputs"], ctx.seed)
    calls_ms, host_ms, ends, done = [], [], [], 0
    cpu = cards.HostCpu()
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    if session:
        with trace.span("stretch"):
            while time.perf_counter() < t_start + tr["trace_seconds"]:
                out, *_, c = call(done % len(args), True)
                kept.offer((done % len(args), out))
                ends.append(c - t_start)
                done += 1
        session.stop()
    while True:
        out, a, b, c = call(done % len(args), False)
        kept.offer((done % len(args), out))
        ends.append(c - t_start)
        done += 1
        if c > t_end:
            break
        calls_ms.append((c - a) * 1e3)
        host_ms.append((b - a) * 1e3)
    notes = [cpu.line(), "calls by 5-s slice, shares of their mean: "
             + " ".join(f"{x:.4f}" for x in stats.slice_rates(ends, ctx.seconds))]
    if dev.type == "cuda":
        notes.append(f"card after the window: {cards.card_state()}")
    del out
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    samples = [(k, program.to_host(o)) for k, o in kept.items]
    values = {"setup_s": t_start - ctx.t0,
              "inversions_per_s": stats.rate_of_calls(ends, tr["batch"])}
    notes.append(f"setup_s {values['setup_s']:.4f}: process start to the window")
    notes.append(f"inversions_per_s over {len(ends)} calls, the last ready "
                 f"{ends[-1]:.6f} s after the {ctx.seconds:g}-s window's start")
    if calls_ms:
        values["call_p95_ms"] = stats.percentile(calls_ms, 95)
        notes.append(f"call_p95_ms over {len(calls_ms)} calls; median "
                     f"{stats.percentile(calls_ms, 50):.4f} ms")
    return Window(values=values, attempted=done, io=answers(tr), samples=samples,
                  memory_peak=peak, spans={"run_raw_host": host_ms},
                  summary=trace.Summary(session.events()) if session else None, notes=notes)
