"""The port's spans and counters (``utils/profiling.py``) on the CPU, the
stream's spans by batch, the library counters, the exporter, and the
benchmark's readers of them on synthetic windows."""

import json
import os
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.ops import cuda_build
from matrix_inversion_tpu_torch.runtime import native
from matrix_inversion_tpu_torch.runtime.api import BatchedMatrixInversion
from matrix_inversion_tpu_torch.runtime.stream import StreamingInverter
from matrix_inversion_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.harness import program_spans, trace  # noqa: E402
from gpubench.harness.runner import Window, _module  # noqa: E402

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
STAGES = {
    "StreamingInverter-producer": {"stream.quantize", "stream.put_wait"},
    "MainThread": {"stream.input_wait", "run_raw", "stream.output_wait"},
    "StreamingInverter-finish": {"stream.fetch", "stream.dequantize"},
}
NEW_METRICS = ("stream_quantize_ms", "stream_dequantize_ms", "stream_input_wait_pct",
               "stream_output_wait_pct", "run_raw_lead_us", "run_raw_launches",
               "setup_library_s")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _stream_run(batches=4):
    p = mt.HIGH.replace(n=3)
    inv = BatchedMatrixInversion(p, 8, backend="packed", io="packed", device="cpu")
    rng = np.random.RandomState(3)
    got = list(StreamingInverter(inv, depth=2, finish_workers=2).run(
        [rng.randn(8, 3, 3) * 10 for _ in range(batches)]))
    assert len(got) == batches


def test_without_a_session_a_span_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    spy = lambda *a, **k: opened.append(a)  # noqa: E731
    monkeypatch.setattr(profiling, "_Range", spy)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    assert not profiling.tracing()
    cm = profiling.span("run_raw", call=1)
    assert cm is profiling._OFF and profiling.tagged(batch=1) is profiling._OFF
    with cm, profiling.span("k1"):
        profiling.count("launch.fused_inverse")
    _stream_run(2)
    assert opened == [] and profiling.spans() == []
    assert profiling.counters() == {"launch.fused_inverse": 1, "stream.host_marshal": 2}
    assert profiling.launches("fused_inverse") == 1 and profiling.launches("mul_window") == 0


def test_a_main_thread_span_is_in_the_trace_on_its_clock():
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with profiling.span("unit", call=7):
            torch.ones(16).add_(1)
    (s,) = profiling.spans()
    assert (s.name, s.thread, s.ids, s.parent, s.traced) == ("unit", "MainThread", {"call": 7},
                                                             None, True)
    (e,) = [e for e in prof.events() if e.name == "mi.unit"]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    assert abs(start_ns + e.time_range.start * 1e3 - s.start_ns) <= 50_000
    assert abs(start_ns + e.time_range.end * 1e3 - s.end_ns) <= 50_000
    assert s.start_ns >= start_ns + e.time_range.start * 1e3 - 1e3  # inside its event
    assert s.end_ns <= start_ns + e.time_range.end * 1e3 + 1e3


def test_worker_threads_record_only_when_they_follow():
    seen = {}

    def work(follow):
        with profiling.following(follow):
            seen[follow] = (profiling.tracing(), profiling.span("w") is profiling._OFF)
            with profiling.span("w", worker=follow):
                pass

    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        for follow in (False, True):
            t = threading.Thread(target=work, args=(follow,), name=f"worker-{follow}")
            t.start()
            t.join()
    assert seen == {False: (False, True), True: (True, False)}
    (s,) = profiling.spans()
    assert (s.thread, s.ids, s.traced) == ("worker-True", {"worker": True}, False)
    assert not any(e.name == "mi.w" for e in prof.events())


def test_a_stream_run_under_a_session_records_every_stage_by_batch():
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        _stream_run(4)
    by = {}
    for s in profiling.spans():
        lane = "StreamingInverter-finish" if s.thread.startswith("StreamingInverter-finish") \
            else s.thread
        if s.name.startswith("stream.") or s.name == "run_raw":
            by.setdefault(s.ids["batch"], []).append((lane, s.name))
            assert s.traced == (lane == "MainThread")
    for k in range(4):
        got = {}
        for lane, name in by[k]:
            got.setdefault(lane, []).append(name)
        assert {lane: set(names) for lane, names in got.items()} == STAGES
        assert all(len(names) == len(set(names)) for names in got.values())
    assert by[4] == [("MainThread", "stream.input_wait")]  # the end of the stream
    calls = [s.ids["call"] for s in profiling.spans() if s.name == "run_raw"]
    assert len(calls) == len(set(calls)) == 4
    traced = {e.name for e in prof.events() if e.name.startswith("mi.")}
    assert traced == {"mi.stream.input_wait", "mi.run_raw", "mi.stream.output_wait"}


def test_a_stream_run_begun_without_a_session_records_nothing():
    _stream_run(3)
    assert profiling.spans() == []


def test_nesting_gives_the_parent_and_tags_carry_ids():
    with torch.profiler.profile(activities=CPU_ONLY):
        with profiling.tagged(batch=5):
            with profiling.span("run_raw", call=1):
                with profiling.span("k1"):
                    pass
        with profiling.span("after"):
            pass
    k1, run_raw, after = profiling.spans()
    assert (k1.name, k1.parent, k1.ids) == ("k1", "run_raw", {"batch": 5})
    assert (run_raw.parent, run_raw.ids) == (None, {"batch": 5, "call": 1})
    assert (after.parent, after.ids) == (None, {})
    assert run_raw.start_ns <= k1.start_ns <= k1.end_ns <= run_raw.end_ns


def _in_threads(work, count=16):
    """``work`` in ``count`` threads at once (more than the cores), the
    interpreter switching threads every µs; every thread must end."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(count)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


def test_the_bounded_buffer_drops_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.following(True):
        for k in range(5):
            with profiling.span("s", k=k):
                pass
    assert [s.ids["k"] for s in profiling.spans()] == [0, 1, 2]
    assert profiling.counters("spans.") == {"spans.dropped": 2}
    profiling.reset()
    monkeypatch.setattr(profiling, "CAPACITY", 500)

    def record():
        with profiling.following(True):
            for _ in range(100):
                with profiling.span("s"):
                    pass
    _in_threads(record)
    assert len(profiling.spans()) == 500
    assert profiling.counters("spans.") == {"spans.dropped": 16 * 100 - 500}


def test_counters_count_from_threads_and_reset():
    def bump():
        for _ in range(2000):
            profiling.count("launch.k")
    _in_threads(bump)
    profiling.count("library.ns", 25)
    assert profiling.counters() == {"launch.k": 32000, "library.ns": 25}
    assert profiling.counters("launch.") == {"launch.k": 32000}
    profiling.reset()
    assert profiling.counters() == {} and profiling.launches("k") == 0


def test_a_host_library_is_built_then_loaded(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    with torch.profiler.profile(activities=CPU_ONLY):
        first = native.build()
        second = native.build()
    assert first == second and first.parent.parent == tmp_path and first.is_file()
    got = profiling.counters("library.")
    assert got["library.built"] == 1 and got["library.loaded"] == 1 and got["library.ns"] > 0
    loads = [s for s in profiling.spans() if s.name == "library"]
    assert [s.ids for s in loads] == [{"lib": "libqmarshal.so"}] * 2
    assert loads[0].end_ns - loads[0].start_ns > loads[1].end_ns - loads[1].start_ns


def test_the_exporter_writes_the_spans_of_unseen_threads(tmp_path):
    def work():
        with profiling.following(True), profiling.span("stream.quantize", batch=0):
            torch.ones(8).add_(1)

    with profiling.device_trace(str(tmp_path)):
        with profiling.span("before"):
            pass
        t = threading.Thread(target=work, name="StreamingInverter-producer")
        t.start()
        t.join()
        with profiling.span("after"):
            pass
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (q,) = [e for e in events if e.get("name") == "mi.stream.quantize"]
    assert q["cat"] == "mi_span" and q["args"]["batch"] == 0 and q["pid"] == os.getpid()
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert lanes[q["tid"]] == "StreamingInverter-producer (mi spans)"
    before, after = ([e for e in events if e.get("name") == f"mi.{n}"] for n in ("before", "after"))
    assert len(before) == len(after) == 1  # in the trace natively, not written twice
    assert before[0]["ts"] + before[0]["dur"] <= q["ts"] <= q["ts"] + q["dur"] <= after[0]["ts"]


# -- the benchmark's readers, on synthetic windows ----------------------------

T0 = 1_792_000_000_000_000_000  # the trace's start, in ns of time.time_ns()


def _span(name, start_us, end_us, thread="MainThread", traced=False, **ids):
    return profiling.Span(name, thread, T0 + int(start_us * 1e3), T0 + int(end_us * 1e3),
                          None, ids, traced)


def _window(events, spans=(), counters=None, monkeypatch=None):
    rec = types.SimpleNamespace(spans=lambda: list(spans), counters=lambda: dict(counters or {}))
    monkeypatch.setattr(program_spans, "recorder", lambda: rec)
    events = [trace.Ev(trace.STRETCH, False, 0, 0.0, 1000.0), *events]
    return Window(values={}, attempted=1, io="packed", samples=[], memory_peak=0,
                  summary=trace.Summary(events))


def _read(name, win):
    return _module("metrics", name, ROOT).read(None, win)


def _device_events():
    out, corr = [], 10
    for a in (10.0, 310.0, 610.0):
        out.append(trace.Ev("mi.run_raw", False, 0, a, a + 100))
        lead = 30.0 + a / 60  # 30.17, 35.17, 40.17
        for dt, api, op in ((lead, "cudaLaunchKernel", "k1"), (lead + 5, "cudaMemsetAsync", "fill")):
            out.append(trace.Ev(api, False, corr, a + dt, a + dt + 2))
            out.append(trace.Ev(op, True, corr, a + 100, a + 200))
            corr += 1
    out.append(trace.Ev("cudaLaunchKernel", False, 99, 900.0, 902.0))  # outside any call
    out.append(trace.Ev("stray", True, 99, 910.0, 920.0))
    return out


def test_the_run_raw_readers_on_a_synthetic_window(monkeypatch):
    win = _window(_device_events(), monkeypatch=monkeypatch)
    assert _read("run_raw_lead_us", win) == pytest.approx(30.0 + (10 + 310 + 610) / 180)
    assert _read("run_raw_launches", win) == 2.0


def _stream_events_and_spans(drift_us=0.0):
    events, spans = [], []
    for k, a in enumerate((100.0, 400.0, 700.0)):
        events.append(trace.Ev("mi.run_raw", False, 0, a, a + 50))
        shift = k * drift_us  # the memory clock's drift from the trace's
        spans.append(_span("run_raw", a - shift + 3, a + 50 - shift - 3, traced=True, batch=k))
    events += [trace.Ev("mi.stream.input_wait", False, 0, 0.0, 100.0),
               trace.Ev("mi.stream.input_wait", False, 0, 300.0, 400.0),
               trace.Ev("mi.stream.output_wait", False, 0, 150.0, 200.0),
               trace.Ev("mi.stream.output_wait", False, 0, 950.0, 1100.0)]  # half out
    producer, finish = "StreamingInverter-producer", "StreamingInverter-finish_0"
    spans += [_span("stream.quantize", 20, 60, producer, batch=1),
              _span("stream.quantize", 320, 380, producer, batch=2),
              _span("stream.quantize", 1100, 1200, producer, batch=3),  # after the stretch
              _span("stream.dequantize", 200, 290, finish, batch=0),
              _span("stream.dequantize", 500, 600, finish, batch=1),
              _span("stream.dequantize", 800, 880, finish, batch=2)]
    return events, spans


def test_the_stream_readers_on_a_synthetic_window(monkeypatch):
    events, spans = _stream_events_and_spans()
    win = _window(events, spans, monkeypatch=monkeypatch)
    assert _read("stream_quantize_ms", win) == pytest.approx(0.050, abs=1e-6)
    assert _read("stream_dequantize_ms", win) == pytest.approx(0.090, abs=1e-6)
    assert _read("stream_input_wait_pct", win) == pytest.approx(20.0)
    assert _read("stream_output_wait_pct", win) == pytest.approx(10.0)
    total = _read("stream_input_wait_pct", win) + _read("stream_output_wait_pct", win)
    assert total <= 100.0


def test_the_stream_readers_give_none_on_an_unsteady_offset(monkeypatch):
    events, spans = _stream_events_and_spans(drift_us=120.0)
    win = _window(events, spans, monkeypatch=monkeypatch)
    assert program_spans.offset_ns(win.summary, spans) is None
    assert _read("stream_quantize_ms", win) is None
    assert _read("stream_dequantize_ms", win) is None
    events, spans = _stream_events_and_spans(drift_us=10.0)  # within 50 µs: steady
    win = _window(events, spans, monkeypatch=monkeypatch)
    assert _read("stream_quantize_ms", win) == pytest.approx(0.050, abs=1e-6)


def test_setup_library_s_reads_the_counter(monkeypatch):
    win = _window([], counters={"library.ns": 1_250_000_000, "library.loaded": 3},
                  monkeypatch=monkeypatch)
    assert _read("setup_library_s", win) == pytest.approx(1.25)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_program_without_spans_gives_no_reading(name, monkeypatch):
    """A program older than its spans: no recorder, no ``mi.*`` events."""
    plain = [e for e in _device_events() + _stream_events_and_spans()[0]
             if not e.name.startswith("mi.")]
    win = _window(plain, monkeypatch=monkeypatch)
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert _read(name, win) is None
