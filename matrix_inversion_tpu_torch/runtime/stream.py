"""Streaming executor: overlap host marshalling with the card's work.

Port of ``matrix_inversion_tpu/runtime/stream.py:35-131``.  While the card
inverts batch k, a producer thread prepares batch k+1 and copies it to the
card, and a pool of finish workers copies batch k-1 back and delivers it, so
a stream of float-in, float-out batches is bound by its slowest stage instead
of the sum of its stages.

A batch takes one of two routes, chosen by what the code can observe: the
inverter's ``io`` and its device's type.

* **On the card** (packed I/O on a CUDA device): the float64 batch crosses
  PCIe as it is, and the card quantizes and dequantizes it
  (``ops/float_io.py``, ``csrc/float_io.cu``, bit for bit the host route).
  The producer copies the caller's batch into a ring of ``depth + 1`` pinned
  float64 buffers (one parallel pass of torch's copy, which releases the
  GIL), copies it to the card with ``non_blocking=True`` on its own CUDA
  stream and records an event there; a slot is written again only after its
  last copy's event has completed.  The consumer, the caller's thread, makes
  its current stream wait on that event, marks the input as used there
  (``record_stream``, so that the caching allocator does not hand its memory
  back to the producer's stream while the kernel reads it), and launches the
  quantize, ``run_raw`` and the dequantize; then it records an event.  A
  finish worker waits on that event on a copy stream of the run, copies the
  float64 results (and the flags, when tracked) into new pinned buffers,
  waits for the copy, and hands those buffers to the caller, who owns them:
  the stream never writes them again.  Each batch counts
  ``stream.device_marshal``.
* **On the host** (digit I/O, or a caller who names ``device="cpu"``): the
  producer quantizes with the native marshaller (``runtime/native.py``),
  straight into a ring of pinned int64 buffers on a card, and copies them as
  above; the consumer calls ``run_raw``; a finish worker copies the outputs
  into pinned host buffers (kept in a free list for the run), waits for the
  copy and dequantizes.  Each batch counts ``stream.host_marshal``.  The
  native library releases the GIL in each call, which is what lets the
  threads overlap.  On the CPU the same code runs without streams, events or
  pinned memory, each batch in arrays of its own.

Only the consumer runs a circuit or launches a kernel, so only it builds or
loads kernels and fills ``ops/packed.py``'s cached constants, and only it
touches the process-global switches (``track_overflow``,
``set_division_impl``, ``plain_arithmetic``).  The producer and the finish
workers only convert on the host, copy and deliver.

Each stage is a span (``utils/profiling.py``) with the batch's number as
``batch=``: the producer's ``stream.slot_wait`` (a reused slot's last copy),
``stream.quantize`` (its host stage: the staging copy on the card's route,
the quantize on the host's), ``stream.h2d`` (the copies and their event
enqueued) and ``stream.put_wait``; the consumer's ``stream.input_wait``,
``run_raw`` and ``stream.output_wait`` (the oldest batch's finish job); a
finish worker's ``stream.fetch`` (new pinned buffers where it takes them,
the wait, the copy back, its synchronize) and ``stream.dequantize`` (its host
stage: the handover on the card's route, the dequantize on the host's).  A
run begun where spans record (under a profiler session) has its producer and
finish workers record for the whole run: the profiler does not see those
threads.
"""

from __future__ import annotations

import functools
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import float_io
from ..utils import profiling


class _ProducerFailure:
    """Sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _put(q, item, stop):
    """Put ``item`` on ``q`` unless the stream is stopped first; returns
    whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def _marshals_on_device(inv):
    """Whether a stream of ``inv`` quantizes and dequantizes on the card:
    packed I/O on a CUDA device."""
    return inv.io == "packed" and inv.device.type == "cuda"


class StreamingInverter:
    """Pipelined batched inversion over an iterator of matrix batches.

    Usage:
        inv = BatchedMatrixInversion(params, B, backend="packed", io="packed")
        stream = StreamingInverter(inv, depth=2)
        for result in stream.run(batches):   # batches: iterable of (B, n, n)
            ...

    On the card's route every result is page-locked (pinned) host memory
    that the caller owns: B * n * n * 8 bytes a batch, which torch's caching
    host allocator rounds up to a power of two (134,217,728 bytes at n=4
    and B = 1,048,576; 268,435,456 for the 209,715,200 at n=10 and
    B = 262,144).  A caller who keeps k results keeps k such blocks pinned;
    with the ``depth + 1`` input slots, whose blocks the last results may
    reuse, the allocator then owns at most k + depth + 1 of them.  A dropped
    result's block stays in that allocator, pinned, for a later batch, so a
    stream whose results are dropped holds a fixed amount.  A caller who
    keeps many results and wants them pageable copies them
    (``np.array(result)``); a finish worker making that copy instead would
    take 38.5 ms a batch at n=4 against 3.4 ms for the copy into the pinned
    buffer it hands over (H100 80GB HBM3 host, 8 cores).
    """

    def __init__(self, batched_inverter, depth: int = 2, finish_workers: int = 2):
        """``depth``: most batches in flight on the device side.
        ``finish_workers``: threads running the fetch + delivery stage; the
        native dequantizer and the copies release the GIL, so more than one
        overlaps the host-side tail.  0 = finish inline, in the consumer."""
        self.inv = batched_inverter
        self.depth = max(1, depth)
        self.finish_workers = max(0, finish_workers)

    def _producer(self, batches, q, stop, copy_stream, on_device, traced):
        with profiling.following(traced):
            self._produce(batches, q, stop, copy_stream, on_device)

    def _produce(self, batches, q, stop, copy_stream, on_device):
        inv = self.inv
        n = inv.params.n
        if on_device:
            shapes, dtype = ((inv.batch_size, n * n),), torch.float64
        else:
            shapes, dtype = inv.input_shapes(), torch.int64
        ring = [None] * (self.depth + 1)  # (pinned tensors, event of their last copy)
        try:
            for k, M in enumerate(batches):
                if stop.is_set():
                    return
                M = np.ascontiguousarray(M, dtype=np.float64)
                if M.shape != (inv.batch_size, n, n):
                    raise ValueError(f"expected a batch of shape {(inv.batch_size, n, n)}, "
                                     f"got {M.shape}")
                host = None
                if copy_stream is not None:
                    slot = k % len(ring)
                    if ring[slot] is None:
                        host = tuple(torch.empty(s, dtype=dtype, pin_memory=True)
                                     for s in shapes)
                    else:
                        host, copied = ring[slot]
                        with profiling.span("stream.slot_wait", batch=k):
                            copied.synchronize()
                with profiling.span("stream.quantize", batch=k):
                    host = self._stage(M, host, on_device)
                if copy_stream is None:
                    item = (host, None)
                else:
                    with profiling.span("stream.h2d", batch=k), torch.cuda.stream(copy_stream):
                        args = tuple(h.to(inv.device, non_blocking=True) for h in host)
                        ready = copy_stream.record_event()
                    ring[slot] = (host, ready)
                    item = (args, ready)
                with profiling.span("stream.put_wait", batch=k):
                    put = _put(q, item, stop)
                if not put:
                    return
            _put(q, None, stop)  # clean end-of-stream
        except BaseException as exc:  # propagate to the consumer, never truncate
            _put(q, _ProducerFailure(exc), stop)

    def _stage(self, M, host, on_device):
        """The producer's host stage of batch ``M``: the floats as they are
        (the card's route) or quantized (the host's), written into the host
        tensors ``host``, or into tensors of their own where it is None."""
        if on_device:
            values = torch.from_numpy(M.reshape(M.shape[0], -1))
            if host is None:
                return (values.clone(),)
            host[0].copy_(values)
            return host
        if host is None:
            return tuple(torch.from_numpy(a) for a in self.inv._host_quantize(M))
        self.inv._host_quantize(M, out=tuple(h.numpy() for h in host))
        return host

    def run(self, batches):
        """Yield dequantized (B, n, n) inverse batches in order, pipelined;
        with ``track_overflow`` each is ``(inverses, flags)``.

        A failure while quantizing or copying any batch re-raises in the
        consumer (after draining results already in flight) instead of
        silently truncating the stream.
        """
        device = self.inv.device
        cuda = device.type == "cuda"
        on_device = _marshals_on_device(self.inv)
        traced = profiling.tracing()  # the workers' spans follow the consumer's
        copy_stream = torch.cuda.Stream(device) if cuda else None
        fetch_stream = torch.cuda.Stream(device) if cuda else None
        free = queue.SimpleQueue()  # pinned output buffers not in use (the host's route)
        finish = functools.partial(self._finish, fetch_stream=fetch_stream, free=free,
                                   on_device=on_device)
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._producer, args=(batches, q, stop, copy_stream, on_device, traced),
            name="StreamingInverter-producer", daemon=True,
        )
        producer.start()
        pool = (
            ThreadPoolExecutor(max_workers=self.finish_workers,
                               thread_name_prefix="StreamingInverter-finish")
            if self.finish_workers
            else None
        )

        def job(out, done, k):
            if pool:
                return pool.submit(self._followed, traced, finish, out, done, k)
            return out, done

        try:
            in_flight = []  # (batch, finish future or (outputs, event) to finish inline)
            failure = None
            for k in itertools.count():
                with profiling.span("stream.input_wait", batch=k):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, _ProducerFailure):
                    failure = item
                    break
                args, ready = item
                done = None
                if cuda:
                    compute = torch.cuda.current_stream(device)
                    compute.wait_event(ready)
                    for t in args:
                        t.record_stream(compute)
                profiling.count("stream.device_marshal" if on_device else "stream.host_marshal")
                with profiling.tagged(batch=k):  # asynchronous on the card
                    out = self._run_on_device(*args) if on_device else self.inv.run_raw(*args)
                if cuda:
                    done = compute.record_event()
                in_flight.append((k, job(out, done, k)))
                while len(in_flight) >= self.depth:
                    yield self._result(*in_flight.pop(0), pool, finish)
            for batch, pending in in_flight:
                yield self._result(batch, pending, pool, finish)
            producer.join()
            if failure is not None:
                raise RuntimeError(
                    "StreamingInverter producer failed while preparing a batch"
                ) from failure.exc
        finally:
            stop.set()  # an abandoned stream's producer stops at its next batch
            if pool:
                # Drop finish jobs that never started so an abandoned stream
                # doesn't keep fetching/dequantizing batches nobody will consume.
                pool.shutdown(wait=False, cancel_futures=True)

    def _run_on_device(self, values):
        """The card's route of one batch: (B, n*n) float64 values -> the
        quantize, ``run_raw`` and the dequantize, launched on the current
        stream -> ``(float64 (B, n*n) results, flags when tracked)``."""
        p = self.inv.params
        fmt = (p.qfloat_len, p.qfloat_ints, p.qfloat_base)
        out = self.inv.run_raw(*float_io.quantize(values, *fmt))
        return (float_io.dequantize(out[0], out[1], *fmt), *out[2:])

    @staticmethod
    def _result(batch, pending, pool, finish):
        if not pool:
            return finish(*pending, batch)
        with profiling.span("stream.output_wait", batch=batch):
            return pending.result()

    @staticmethod
    def _followed(traced, finish, *job):
        """``finish(*job)`` in a finish worker, its spans recording if the
        run's consumer's do (``traced``)."""
        with profiling.following(traced):
            return finish(*job)

    def _finish(self, out, done, batch, fetch_stream, free, on_device):
        """Fetch batch ``batch``'s outputs to the host and deliver them:
        dequantized on the host's route, handed over on the card's."""
        outs = out if isinstance(out, tuple) else (out,)
        if done is None:
            with profiling.span("stream.fetch", batch=batch):
                host = tuple(o.numpy() for o in outs)
            with profiling.span("stream.dequantize", batch=batch):
                return self._deliver(host, out, on_device)
        pinned = None
        if not on_device:  # the host's route reuses its buffers; the card's hands them over
            try:
                pinned = free.get_nowait()
            except queue.Empty:
                pass
        try:
            with profiling.span("stream.fetch", batch=batch):
                if pinned is None:
                    pinned = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                                   for o in outs)
                self._fetch(outs, pinned, done, fetch_stream)
            with profiling.span("stream.dequantize", batch=batch):
                return self._deliver(tuple(h.numpy() for h in pinned), out, on_device)
        finally:
            if not on_device and pinned is not None:
                free.put(pinned)

    @staticmethod
    def _fetch(outs, pinned, done, fetch_stream):
        """Copy the device tensors ``outs`` into the pinned ``pinned`` on
        ``fetch_stream`` after the event ``done``, and wait for the copy."""
        with torch.cuda.stream(fetch_stream):
            fetch_stream.wait_event(done)
            for h, o in zip(pinned, outs):
                h.copy_(o, non_blocking=True)
            fetch_stream.record_event().synchronize()

    def _deliver(self, host, out, on_device):
        """A batch's host arrays as the caller gets them: on the card's route
        the float64 results, reshaped, and the flags when tracked, handed over
        as they are; on the host's route dequantized (a copy of the flags)."""
        if not on_device:
            return self.inv._host_dequantize(host if isinstance(out, tuple) else host[0])
        n = self.inv.params.n
        values = host[0].reshape(-1, n, n)
        return (values, host[1]) if self.inv.track_overflow else values
