"""Streaming executor: overlap host marshalling with the card's work.

Port of ``matrix_inversion_tpu/runtime/stream.py:35-131``.  While the card
inverts batch k, a producer thread quantizes batch k+1 and copies it to the
card, and a pool of finish workers copies batch k-1 back and dequantizes it,
so a stream of float-in, float-out batches is bound by its slowest stage
instead of the sum of its stages.

On a CUDA device:

* the producer quantizes straight into a ring of ``depth + 1`` pinned host
  buffers (the native marshaller writes into their numpy views), copies each
  to the card with ``non_blocking=True`` on its own CUDA stream and records
  an event there; a slot is written again only after its last copy's event
  has completed;
* the consumer, the caller's thread, makes its current stream wait on that
  event, marks the inputs as used there (``record_stream``, so that the
  caching allocator does not hand their memory back to the producer's stream
  while the kernel reads it) and calls ``run_raw``, then records an event
  after it;
* each finish worker waits on that event on a copy stream of the run, copies
  the outputs into pinned host buffers (kept in a free list for the run),
  waits for the copy and dequantizes.

Only the consumer runs a circuit, so only it builds or loads kernels and
fills ``ops/packed.py``'s cached constants, and only it touches the
process-global switches (``track_overflow``, ``set_division_impl``,
``plain_arithmetic``).  The producer and the finish workers only quantize,
copy and dequantize; the native library (``runtime/native.py``) releases
the GIL in each call, which is what lets them overlap.  On the CPU (a caller
who names ``device="cpu"``) the same code runs without streams, events or
pinned memory, each batch in arrays of its own.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


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


class StreamingInverter:
    """Pipelined batched inversion over an iterator of matrix batches.

    Usage:
        inv = BatchedMatrixInversion(params, B, backend="packed", io="packed")
        stream = StreamingInverter(inv, depth=2)
        for result in stream.run(batches):   # batches: iterable of (B, n, n)
            ...
    """

    def __init__(self, batched_inverter, depth: int = 2, finish_workers: int = 2):
        """``depth``: most batches in flight on the device side.
        ``finish_workers``: threads running the fetch + dequantize stage; the
        native dequantizer releases the GIL, so more than one overlaps the
        host-side tail.  0 = dequantize inline, in the consumer."""
        self.inv = batched_inverter
        self.depth = max(1, depth)
        self.finish_workers = max(0, finish_workers)

    def _producer(self, batches, q, stop, copy_stream):
        inv = self.inv
        n = inv.params.n
        shapes = inv.input_shapes()
        ring = [None] * (self.depth + 1)  # (pinned tensors, event of their last copy)
        try:
            for k, M in enumerate(batches):
                if stop.is_set():
                    return
                M = np.asarray(M, dtype=np.float64)
                if M.shape != (inv.batch_size, n, n):
                    raise ValueError(f"expected a batch of shape {(inv.batch_size, n, n)}, "
                                     f"got {M.shape}")
                if copy_stream is None:
                    item = (tuple(torch.from_numpy(a) for a in inv._host_quantize(M)), None)
                else:
                    slot = k % len(ring)
                    if ring[slot] is None:
                        host = tuple(torch.empty(s, dtype=torch.int64, pin_memory=True)
                                     for s in shapes)
                    else:
                        host, copied = ring[slot]
                        copied.synchronize()
                    inv._host_quantize(M, out=tuple(h.numpy() for h in host))
                    with torch.cuda.stream(copy_stream):
                        args = tuple(h.to(inv.device, non_blocking=True) for h in host)
                        ready = copy_stream.record_event()
                    ring[slot] = (host, ready)
                    item = (args, ready)
                if not _put(q, item, stop):
                    return
            _put(q, None, stop)  # clean end-of-stream
        except BaseException as exc:  # propagate to the consumer, never truncate
            _put(q, _ProducerFailure(exc), stop)

    def run(self, batches):
        """Yield dequantized (B, n, n) inverse batches in order, pipelined;
        with ``track_overflow`` each is ``(inverses, flags)``.

        A failure while quantizing or copying any batch re-raises in the
        consumer (after draining results already in flight) instead of
        silently truncating the stream.
        """
        device = self.inv.device
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None
        fetch_stream = torch.cuda.Stream(device) if cuda else None
        free = queue.SimpleQueue()  # pinned output buffers not in use
        q = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._producer, args=(batches, q, stop, copy_stream),
            name="StreamingInverter-producer", daemon=True,
        )
        producer.start()
        pool = (
            ThreadPoolExecutor(max_workers=self.finish_workers,
                               thread_name_prefix="StreamingInverter-finish")
            if self.finish_workers
            else None
        )

        def finish(out, done):
            if pool:
                return pool.submit(self._finish, out, done, fetch_stream, free)
            return out, done

        try:
            in_flight = []  # finish futures, or (outputs, event) to finish inline
            failure = None
            while True:
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
                out = self.inv.run_raw(*args)  # asynchronous on the card
                if cuda:
                    done = compute.record_event()
                in_flight.append(finish(out, done))
                while len(in_flight) >= self.depth:
                    yield self._result(in_flight.pop(0), pool, fetch_stream, free)
            for job in in_flight:
                yield self._result(job, pool, fetch_stream, free)
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

    def _result(self, job, pool, fetch_stream, free):
        return job.result() if pool else self._finish(*job, fetch_stream, free)

    def _finish(self, out, done, fetch_stream, free):
        """Fetch one batch's outputs to the host and dequantize them."""
        outs = out if isinstance(out, tuple) else (out,)
        if done is None:
            host = tuple(o.numpy() for o in outs)
            return self.inv._host_dequantize(host if isinstance(out, tuple) else host[0])
        try:
            pinned = free.get_nowait()
        except queue.Empty:
            pinned = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs)
        try:
            with torch.cuda.stream(fetch_stream):
                fetch_stream.wait_event(done)
                for h, o in zip(pinned, outs):
                    h.copy_(o, non_blocking=True)
                fetch_stream.record_event().synchronize()
            host = tuple(h.numpy() for h in pinned)
            return self.inv._host_dequantize(host if isinstance(out, tuple) else host[0])
        finally:
            free.put(pinned)
