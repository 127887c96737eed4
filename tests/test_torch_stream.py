"""Port vs JAX package: the streaming executor (``runtime/stream.py``).

The four cases of ``tests/test_stream.py`` on ``device="cpu"`` (where the
pipeline runs without CUDA streams, events or pinned memory), each held bit
for bit to the JAX package's ``StreamingInverter`` on the same batches
(LOW n=2 and n=3, packed I/O), and to the port's ``inv.run``; then a tracked
stream (flags included), digit I/O, a stream abandoned after one result,
a batch of the wrong shape, and an n=13 stream on the op-by-op path.  The
JAX inverters are module-scoped: their jit compiles are most of the time.
"""

import threading

import numpy as np
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched
from matrix_inversion_tpu.runtime.stream import StreamingInverter as JaxStream

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.ops import packed
from matrix_inversion_tpu_torch.runtime import stream as stream_module
from matrix_inversion_tpu_torch.runtime.stream import StreamingInverter

torch.set_num_threads(2)


def pair(n, B, **kw):
    """(JAX inverter, port inverter on the CPU) for LOW n, packed I/O unless
    ``io`` says otherwise."""
    io = kw.pop("io", "packed")
    return (JaxBatched(mi.LOW.replace(n=n), B, backend="packed", io=io, **kw),
            mt.BatchedMatrixInversion(mt.LOW.replace(n=n), B, backend="packed", io=io,
                                      device="cpu", **kw))


@pytest.fixture(scope="module")
def n2():
    return pair(2, 4)


@pytest.fixture(scope="module")
def n3():
    return pair(3, 8)


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


def test_streaming_matches_direct(n3, rng):
    jax_inv, inv = n3
    batches = [rng.randn(8, 3, 3) * 100 for _ in range(5)]
    streamed = list(StreamingInverter(inv, depth=2).run(iter(batches)))
    assert len(streamed) == 5
    assert_batches_equal(streamed, [inv.run(M) for M in batches])
    assert_batches_equal(streamed, list(JaxStream(jax_inv, depth=2).run(iter(batches))))


def test_streaming_depth_one(n2, rng):
    jax_inv, inv = n2
    batches = [rng.randn(4, 2, 2) * 100 for _ in range(3)]
    outs = list(StreamingInverter(inv, depth=1).run(iter(batches)))
    assert len(outs) == 3
    for M, out in zip(batches, outs):
        assert np.mean(np.abs(out - np.linalg.inv(M))) < 1.0
    assert_batches_equal(outs, list(JaxStream(jax_inv, depth=1).run(iter(batches))))


@pytest.mark.parametrize("stream_cls", [StreamingInverter, JaxStream], ids=["port", "jax"])
def test_streaming_producer_failure_raises(n2, stream_cls):
    """A failing batch raises in the consumer after the results in flight
    drain, in both packages, from the producer's exception."""
    jax_inv, inv = n2
    rng = np.random.RandomState(3)
    good = [rng.randn(4, 2, 2) * 100 for _ in range(2)]

    def batches():
        yield from good
        yield "not a matrix"  # quantize raises in the producer thread

    got = []
    with pytest.raises(RuntimeError, match="producer failed") as info:
        for out in stream_cls(inv if stream_cls is StreamingInverter else jax_inv,
                              depth=2).run(batches()):
            got.append(out)
    assert isinstance(info.value.__cause__, ValueError)
    assert_batches_equal(got, [inv.run(M) for M in good])


def test_stream_finish_pool_matches_inline(n3, rng):
    jax_inv, inv = n3
    batches = [rng.randn(8, 3, 3) * 100 for _ in range(5)]
    inline = list(StreamingInverter(inv, depth=2, finish_workers=0).run(batches))
    pooled = list(StreamingInverter(inv, depth=2, finish_workers=3).run(batches))
    assert len(inline) == len(pooled) == 5
    assert_batches_equal(pooled, inline)
    assert_batches_equal(pooled, list(JaxStream(jax_inv, depth=2, finish_workers=3).run(batches)))


def overflowy(rng, B, n):
    """x100 matrices, every other one with two rows equal up to 1e-12: its
    inverse overflows the integer range."""
    M = rng.randn(B, n, n) * 100
    M[::2, 1] = M[::2, 0] * (1 + 1e-12)
    return M


def test_tracked_stream_matches_jax():
    jax_inv, inv = pair(2, 4, track_overflow=True)
    rng = np.random.RandomState(5)
    batches = [overflowy(rng, 4, 2) for _ in range(3)]
    streamed = list(StreamingInverter(inv, depth=2).run(batches))
    assert all(isinstance(s, tuple) and s[1].dtype == np.int32 for s in streamed)
    assert all(s[1].tolist() == [1, 0, 1, 0] for s in streamed)
    assert_batches_equal(streamed, [inv.run(M) for M in batches])
    assert_batches_equal(streamed, list(JaxStream(jax_inv, depth=2).run(batches)))


def test_digit_stream_matches_jax():
    jax_inv, inv = pair(2, 4, io="digits")
    rng = np.random.RandomState(6)
    batches = [rng.randn(4, 2, 2) * 100 for _ in range(3)]
    streamed = list(StreamingInverter(inv, depth=2, finish_workers=0).run(batches))
    assert_batches_equal(streamed, [inv.run(M) for M in batches])
    assert_batches_equal(streamed, list(JaxStream(jax_inv, depth=2).run(batches)))


def test_abandoned_stream_stops(n2, monkeypatch):
    """Closing the stream after one result neither hangs nor leaves threads:
    the pool is shut down without waiting and its queued jobs cancelled, and
    the producer stops although its queue is full."""
    _, inv = n2
    shutdowns = []

    class Pool(stream_module.ThreadPoolExecutor):
        def shutdown(self, wait=True, *, cancel_futures=False):
            shutdowns.append((wait, cancel_futures))
            super().shutdown(wait=wait, cancel_futures=cancel_futures)

    monkeypatch.setattr(stream_module, "ThreadPoolExecutor", Pool)
    rng = np.random.RandomState(7)
    results = StreamingInverter(inv, depth=2).run(rng.randn(4, 2, 2) * 100 for _ in range(50))
    first = next(results)
    assert first.shape == (4, 2, 2)
    results.close()
    assert shutdowns == [(False, True)]
    for thread in threading.enumerate():
        if thread.name.startswith("StreamingInverter"):
            thread.join(timeout=10)
            assert not thread.is_alive(), f"{thread.name} still running"


def test_wrong_shape_batch_fails_the_producer(n2):
    _, inv = n2
    with pytest.raises(RuntimeError, match="producer failed") as info:
        list(StreamingInverter(inv).run([np.zeros((3, 2, 2))]))
    assert "expected a batch of shape (4, 2, 2)" in str(info.value.__cause__)


def test_op_by_op_stream_fills_constants_on_the_consumer(monkeypatch):
    """n=13 runs op by op, whose reciprocals read ``packed._constant_word``:
    only the consumer (the caller's thread) runs the circuit, so only it
    fills the constants, on its own stream, before the producer's and the
    finish workers' threads could need them; they need none."""
    inv = mt.BatchedMatrixInversion(mt.LOW.replace(n=13), 2, io="packed", device="cpu")
    rng = np.random.RandomState(8)
    batches = [rng.randn(2, 13, 13) * 100 for _ in range(2)]
    threads = set()
    real = packed._constant_word

    def constant_word(value, device):
        threads.add(threading.current_thread().name)
        return real(value, device)

    monkeypatch.setattr(packed, "_constant_word", constant_word)
    streamed = list(StreamingInverter(inv, depth=2).run(batches))
    assert threads == {threading.current_thread().name}
    assert_batches_equal(streamed, [inv.run(M) for M in batches])


def test_stream_order_under_thread_stress(n2):
    """More finish workers than cores and a short switch interval: every
    batch still comes back in order, equal to ``inv.run``."""
    import sys

    _, inv = n2
    rng = np.random.RandomState(9)
    batches = [rng.randn(4, 2, 2) * 100 for _ in range(40)]
    want = [inv.run(M) for M in batches]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(StreamingInverter(inv, depth=4, finish_workers=12).run(batches))
    finally:
        sys.setswitchinterval(interval)
    assert_batches_equal(got, want)
