"""The metrics' arithmetic on synthetic samples and event lists: percentiles,
rates, idle shares, the launch attribution by correlation id, the
rooflines and the sample of answers."""

import types

import numpy as np
import pytest

from gpubench.harness import manifest, stats, trace
from gpubench.harness.checks import Reservoir
from gpubench.harness.runner import _module

Ev = trace.Ev


def test_percentile_interpolates_as_numpy():
    rng = np.random.default_rng(0)
    for size in (1, 2, 7, 100, 1001):
        xs = list(rng.exponential(size=size))
        for q in (0, 50, 95, 100):
            assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(4659 * 1048576, 3.0) == 4659 * 1048576 / 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_the_rate_of_calls_is_over_their_own_time():
    batch = 262144
    # twelve calls of 2.4 s, and a thirteenth whose outputs are ready after
    # the window's close at 30 s: all thirteen over their 31.2 s
    ends = [2.4 * k for k in range(1, 14)]
    assert stats.rate_of_calls(ends, batch) == pytest.approx(batch / 2.4, rel=1e-12)
    assert stats.rate(12 * batch, 30.0) == pytest.approx(0.96 * batch / 2.4, rel=1e-12)
    # calls of 0.7 ms fill the window to within one call: the two agree
    ends = [0.0007 * k for k in range(1, int(30 / 0.0007) + 2)]
    old = stats.rate((len(ends) - 1) * batch, 30.0)
    assert stats.rate_of_calls(ends, batch) == pytest.approx(old, rel=1e-4)
    # a stall of 10.5 s from 20 s on, cut by the close, costs a third
    ends = [0.001 * k for k in range(1, 20001)] + [30.5]
    assert stats.rate_of_calls(ends, batch) == pytest.approx(20001 * batch / 30.5, rel=1e-12)
    assert stats.rate_of_calls(ends, batch) < 0.67 * stats.rate_of_calls(ends[:-1], batch)
    assert stats.rate_of_calls([], batch) == 0


def test_busy_gaps_and_idle_share():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12), (-3, -1)]
    assert stats.merged(iv, 0, 10) == [(0, 3), (5, 6), (9, 10)]
    assert stats.busy(iv, 0, 10) == 5
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.idle_share(iv, 0, 10) == pytest.approx(50.0)
    assert stats.idle_share([], 0, 4) == 100.0
    assert stats.gaps([], 2, 4) == [(2, 4)]
    with pytest.raises(ValueError):
        stats.idle_share(iv, 3, 3)


def _events():
    """Two run_raw spans in a stretch [0, 1000] us: the first launches K1
    (correlation 1) and a copy (2), the second K1 (3); a kernel launched
    outside any span (4) and the device annotation of a span are there too."""
    return [
        Ev("gpubench.stretch", False, 0, 0, 1000),
        Ev("gpubench.run_raw", False, 0, 10, 60),
        Ev("cudaLaunchKernel", False, 1, 20, 25),
        Ev("cudaMemcpyAsync", False, 2, 30, 35),
        Ev("gpubench.sync", False, 0, 60, 490),
        Ev("cudaDeviceSynchronize", False, 0, 61, 489),
        Ev("gpubench.run_raw", False, 0, 500, 550),
        Ev("cudaLaunchKernel", False, 3, 510, 515),
        Ev("cudaLaunchKernel", False, 4, 700, 705),
        Ev("qcell::fused_inverse_kernel(qcell::Arrays, int)", True, 1, 100, 300),
        Ev("Memcpy DtoD (Device -> Device)", True, 2, 300, 350),
        Ev("qcell::fused_inverse_kernel(qcell::Arrays, int)", True, 3, 600, 800),
        Ev("elementwise_kernel", True, 4, 800, 850),
        Ev("gpubench.run_raw", True, 0, 100, 350),
        Ev("qcell::fused_inverse_kernel(qcell::Arrays, int)", True, 9, 2000, 2100),
    ]


def test_summary_attributes_device_work_to_its_launching_span():
    s = trace.Summary(_events())
    assert s.window_s == pytest.approx(1e-3)
    assert s.span_count("run_raw") == 2 and s.span_count("sync") == 1
    launched = s.launched_by("run_raw")
    assert sorted(e.corr for e in launched) == [1, 2, 3]
    assert s.busy_s() == pytest.approx(500e-6)
    assert s.idle_pct() == pytest.approx(50.0)
    ops = dict(s.device_ops())
    assert ops["qcell::fused_inverse_kernel(qcell::Arrays, int)"] == pytest.approx(400e-6)
    gaps = dict(s.idle_gaps())
    assert gaps["cudaDeviceSynchronize (1 gaps)"] == pytest.approx(250e-6)
    assert gaps["gpubench.run_raw (1 gaps)"] == pytest.approx(100e-6)
    assert gaps["no host event (1 gaps)"] == pytest.approx(150e-6)
    assert sum(gaps.values()) == pytest.approx(500e-6)


def test_summary_refuses_work_without_a_launch_and_a_missing_stretch():
    with pytest.raises(ValueError):
        trace.Summary([e for e in _events() if e.name != "gpubench.stretch"])
    orphan = _events() + [Ev("stray", True, 99, 10, 20)]
    with pytest.raises(ValueError):
        trace.Summary(orphan).launched_by("run_raw")


def _window(summary=None, **spans):
    return types.SimpleNamespace(summary=summary, spans=spans)


def test_k1_roofline_is_the_frozen_bound_over_the_device_time_a_call():
    cell = manifest.cell("high_n4.device")
    s = trace.Summary(_events())
    got = _module("metrics", "k1_roofline_pct", manifest.ROOT).read(cell, _window(s))
    roof, batch = cell.config["roofline"], cell.traffic["batch"]
    bound = max(roof["instructions_per_inversion"] * batch / roof["issue_rate_per_s"],
                roof["bytes_per_inversion"] * batch / roof["memory_bytes_per_s"])
    assert bound == pytest.approx(6824 * 1048576 / 33.45408e12)
    assert got == pytest.approx(100 * bound / (450e-6 / 2))
    assert _module("metrics", "k1_roofline_pct", manifest.ROOT).read(cell, _window()) is None


def test_digit_io_reads_the_work_that_is_not_k1():
    cell = manifest.cell("high_n4.digits")
    reader = _module("metrics", "digit_io_ms", manifest.ROOT)
    assert reader.read(cell, _window(trace.Summary(_events()))) == pytest.approx(0.05 / 2)
    k1_only = [e for e in _events() if not e.name.startswith("Memcpy")]
    assert reader.read(cell, _window(trace.Summary(k1_only))) is None


def test_span_readers():
    cell = manifest.cell("high_n4.stream")
    host = _module("metrics", "run_raw_host_ms", manifest.ROOT)
    marshal = _module("metrics", "marshal_ms", manifest.ROOT)
    assert host.read(cell, _window(run_raw_host=[0.1, 0.2, 0.6])) == pytest.approx(0.3)
    assert host.read(cell, _window()) is None
    assert marshal.read(cell, _window(marshal_alone=[5.0, 1.0, 3.0, 9.0, 2.0])) == 3.0
    tail = _module("metrics", "stream_batch_p95_ms", manifest.ROOT)
    assert tail.read(cell, _window(batch_latency=list(range(1, 101)))) == pytest.approx(95.05)
    assert tail.read(cell, _window()) is None
    for name in ("idle_pct", "stream_idle_pct"):
        reader = _module("metrics", name, manifest.ROOT)
        assert reader.read(cell, _window(trace.Summary(_events()))) == pytest.approx(50.0)
        assert reader.read(cell, _window()) is None


def test_reservoir_keeps_a_seeded_uniform_sample():
    r = Reservoir(4, seed=2**31 + 5)
    for i in range(3):
        r.offer(i)
    assert r.items == [0, 1, 2]
    for i in range(3, 1000):
        r.offer(i)
    assert len(r.items) == 4 and r.seen == 1000
    again = Reservoir(4, seed=2**31 + 5)
    for i in range(1000):
        again.offer(i)
    assert again.items == r.items
    counts = np.zeros(10)
    for seed in range(2000):
        s = Reservoir(2, seed)
        for i in range(10):
            s.offer(i)
        counts[s.items] += 1
    assert counts.min() > 300 and counts.max() < 500  # 400 each if uniform


def test_slice_rates_are_shares_of_the_mean_over_whole_slices():
    ends = [0.5, 1.0, 4.9, 5.0, 7.5, 9.9, 10.2, 11.0, 11.5, 12.0, 14.0, 14.9]
    # 12 s of window: two whole 5-s slices; the last 2 s and anything later are left out
    assert stats.slice_rates(ends, 12.0) == [1.0, 1.0]
    assert stats.slice_rates([1.0, 6.0, 7.0, 8.0], 10.0) == [0.5, 1.5]
    assert stats.slice_rates([], 10.0) == [] and stats.slice_rates([1.0], 4.0) == []
