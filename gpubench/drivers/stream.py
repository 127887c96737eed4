"""Float batches in, float inverses out, through ``StreamingInverter``.

Set-up makes one serial ``inv.run`` (the marshaller's and the kernel's
libraries load there).  Then one stream runs over the pool's batches in
turn, as a generator that the stream's producer pulls from; the first
``warm_batches`` results are set-up, and the window starts when the last of
them comes out.  A batch counts when its floats come out inside the window;
its latency runs from the moment the producer pulled it.  Once the window
has closed the generator ends and the batches in flight drain.

Traffic parameters: ``batch``, ``pool``, ``depth``, ``finish_workers``,
``warm_batches``, ``keep_outputs``, ``trace_seconds``, ``marshal_repeats``.

Spans: ``batch_latency`` (ms of each counted batch that came out after the
profiled stretch); ``marshal_alone`` (traced runs, after the window: ms of
the stream's own host quantize into pinned buffers plus its host dequantize
out of pinned buffers, of one pool batch, outside the stream,
``marshal_repeats`` times).
"""

from __future__ import annotations

import threading
import time

from gpubench.harness import device as cards, program, stats, trace
from gpubench.harness.checks import Reservoir
from gpubench.harness.runner import Window


def _marshal_alone(inv, floats, device, repeats):
    """ms of the stream's own host calls on one batch, outside the stream:
    quantize into pinned buffers (the producer's) plus dequantize out of
    pinned buffers (a finish worker's), one after the other."""
    import torch

    pin = device.type == "cuda"
    host_in = tuple(torch.empty(s, dtype=torch.int64, pin_memory=pin)
                    for s in inv.input_shapes())
    program.host_quantize(inv, floats, host_in)
    result = inv.run_raw(*(h.to(device) for h in host_in))
    outs = result if isinstance(result, tuple) else (result,)
    host_out = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=pin) for o in outs)
    for h, o in zip(host_out, outs):
        h.copy_(o)
    host_out = host_out if isinstance(result, tuple) else host_out[0]
    out = []
    for _ in range(repeats):
        a = time.perf_counter()
        program.host_quantize(inv, floats, host_in)
        program.host_dequantize(inv, host_out)
        out.append((time.perf_counter() - a) * 1e3)
    return out


def answers(traffic):
    """The form of the answers that a run's check compares."""
    return "floats"


def run(ctx):
    import torch

    tr, dev = ctx.cell.traffic, ctx.device
    inv = program.inverter(ctx.cell.config, tr["batch"], "packed", dev)
    floats = [batch.numpy() for batch in ctx.pool]
    inv.run(floats[0])
    ctx.mark("first batch")
    session = trace.Session(dev.type == "cuda") if ctx.trace else None
    stream = program.streaming(inv, tr["depth"], tr["finish_workers"])
    pulled, stop = [], threading.Event()

    def batches():
        k = 0
        while not stop.is_set():
            pulled.append(time.perf_counter())
            yield floats[k % len(floats)]
            k += 1

    warm = tr["warm_batches"]
    kept = Reservoir(tr["keep_outputs"], ctx.seed)
    latency_ms, unprofiled_ms, ends, t_start, stretch = [], [], [], None, None
    for k, out in enumerate(stream.run(batches())):
        now = time.perf_counter()
        if k < warm - 1:
            continue
        if k == warm - 1:
            t_start = now
            ctx.mark("warm")
            cpu = cards.HostCpu()
            if session:
                stretch = trace.span("stretch")
                stretch.__enter__()
            continue
        if stretch and now >= t_start + tr["trace_seconds"]:
            stretch.__exit__(None, None, None)
            stretch = None
            session.stop()
        if now <= t_start + ctx.seconds:
            latency_ms.append((now - pulled[k]) * 1e3)
            ends.append(now - t_start)
            if not stretch:
                unprofiled_ms.append(latency_ms[-1])
            kept.offer((k % len(floats), out))
        else:
            stop.set()
    if stretch:
        stretch.__exit__(None, None, None)
    if session:
        session.stop()
    notes = [cpu.line(), "batches by 5-s slice, shares of their mean: "
             + " ".join(f"{x:.4f}" for x in stats.slice_rates(ends, ctx.seconds))]
    if dev.type == "cuda":
        notes.append(f"card after the window: {cards.card_state()}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    spans = {"batch_latency": unprofiled_ms}
    if ctx.trace:
        spans["marshal_alone"] = _marshal_alone(inv, floats[0], dev, tr["marshal_repeats"])
    values = {"setup_s": t_start - ctx.t0,
              "stream_inversions_per_s": stats.rate(len(latency_ms) * tr["batch"], ctx.seconds)}
    notes.append(f"setup_s {values['setup_s']:.4f}: process start to the window")
    if latency_ms:
        notes.append(f"{len(latency_ms)} batches in the window; latency median "
                     f"{stats.percentile(latency_ms, 50):.4f} ms, p95 "
                     f"{stats.percentile(latency_ms, 95):.4f} ms")
    return Window(values=values, attempted=len(latency_ms), io=answers(tr), samples=kept.items,
                  memory_peak=peak, spans=spans,
                  summary=trace.Summary(session.events()) if session else None, notes=notes)
