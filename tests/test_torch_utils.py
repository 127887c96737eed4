"""The port's utilities on the CPU: timing, profiling, samplers, and the
entry point's default device."""

import json
import os
import types

import numpy as np
import pytest
import torch

from matrix_inversion_tpu.utils import samplers as jax_samplers
from matrix_inversion_tpu.utils import timing as jax_timing

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.utils import profiling, samplers, timing

torch.set_num_threads(2)


def _jax_stats_keys():
    """The ``stats`` keys of the JAX package's helpers, from one tiny run."""
    _, chain = jax_timing.timed_chain(lambda s: s + 1, lambda s: None, 0, 2, 2)
    _, marginal = jax_timing.timed_marginal(lambda s: s + 1, lambda s: None, 0, 2, 2)
    return set(chain), set(marginal)


def test_timed_chain_stats_keys_match_jax():
    chain_keys, _ = _jax_stats_keys()
    calls = []
    med, stats = timing.timed_chain(
        lambda s: s + 1, lambda s: calls.append(int(s[0])), torch.zeros(4), reps=5, repeats=4)
    assert set(stats) == chain_keys            # no "card" on the CPU
    assert calls == [5, 5, 5, 5]               # the chain is data-dependent, fenced per pass
    assert stats["reps"] == 5 and stats["timing_repeats"] == 4
    assert len(stats["elapsed_all_s"]) == 4 and med >= 0
    assert stats["elapsed_min_s"] <= stats["elapsed_median_s"] <= stats["elapsed_max_s"]
    assert stats["platform"] == "cpu" and stats["device_kind"] == "cpu"


def test_timed_marginal_keys_and_unreliable_flag(monkeypatch):
    _, marginal_keys = _jax_stats_keys()
    per_rep, stats = timing.timed_marginal(
        lambda s: s + 1, lambda s: None, torch.zeros(4), reps=3, repeats=3)
    assert set(stats) == marginal_keys
    assert per_rep >= 1e-12 and stats["reps"] == 3
    assert set(stats["chain_reps"]) == set(stats["chain_2reps"])
    assert stats["chain_2reps"]["reps"] == 6

    # a step whose cost swings more from pass to pass than a rep costs: the
    # difference of the chains does not clear the jitter
    def clock(ticks):
        ticks = iter(ticks)
        return types.SimpleNamespace(time=lambda: next(ticks))

    monkeypatch.setattr(timing, "time", clock(
        [0.0, 1.0, 0.0, 1.5, 0.0, 1.1, 0.0, 1.2, 0.0, 1.0, 0.0, 1.6]))
    _, noisy = timing.timed_marginal(lambda s: s, lambda s: None, 0, reps=2, repeats=3)
    assert noisy["marginal_reliable"] is False
    # and one whose chains differ clearly
    monkeypatch.setattr(timing, "time", clock(
        [0.0, 1.0, 0.0, 1.01, 0.0, 1.0, 0.0, 2.0, 0.0, 2.01, 0.0, 2.0]))
    per_rep, clean = timing.timed_marginal(lambda s: s, lambda s: None, 0, reps=2, repeats=3)
    assert clean["marginal_reliable"] is True and per_rep == pytest.approx(0.5)
    assert clean["fixed_overhead_s"] == 0.0


def test_measure_time_and_synchronize(capsys):
    out, seconds = timing.measure_time(lambda a, b: a + b, "adding", True, 2, 3)
    assert out == 5 and seconds >= 0 and "adding" in capsys.readouterr().out
    out, _ = timing.measure_time(lambda: 7, "quiet", False)
    assert out == 7 and capsys.readouterr().out == ""
    timing.synchronize("cpu")  # nothing to wait for


def test_device_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir)) as prof:
        (torch.ones(64) * 2).sum()
    files = os.listdir(logdir)
    assert files == ["trace.json"]
    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mul" in e.key for e in prof.key_averages())


def test_timed_and_dump_stats(tmp_path, capsys):
    results = {}
    with profiling.timed("step", results):
        pass
    assert results["step"] >= 0
    with profiling.timed("printed"):
        pass
    assert "printed" in capsys.readouterr().out
    path = tmp_path / "stats.jsonl"
    line = profiling.dump_stats({"additions": 3}, str(path))
    profiling.dump_stats({"additions": 4}, str(path))
    assert json.loads(line) == {"additions": 3}
    assert [json.loads(x) for x in path.read_text().splitlines()] == [
        {"additions": 3}, {"additions": 4}]


@pytest.mark.parametrize("name", ["Normal", "Uniform"])
def test_samplers_give_jax_arrays(name):
    for make_rng in (np.random.RandomState, np.random.default_rng):
        want = jax_samplers.SAMPLERS[name](4, rng=make_rng(7))(batch=(3,))
        got = samplers.SAMPLERS[name](4, rng=make_rng(7))(batch=(3,))
        assert got.shape == (3, 4, 4) and got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert samplers.normal_sampler(2, scale=1.0, rng=np.random.RandomState(0))().shape == (2, 2)
    low_high = samplers.uniform_sampler(3, low=-1.0, high=1.0, rng=np.random.RandomState(1))()
    assert (np.abs(low_high) <= 1.0).all()


def test_default_device_is_the_card_and_raises_without_one():
    """``BatchedMatrixInversion(params, batch)`` targets CUDA; here there is
    none, so the constructor raises and never carries on on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device"):
        mt.BatchedMatrixInversion(mt.HIGH.replace(n=4), 8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mt.BatchedMatrixInversion(mt.HIGH.replace(n=4), 8, device="cuda:0")
    inv = mt.BatchedMatrixInversion(mt.HIGH.replace(n=4), 8, device="cpu")
    assert inv.device.type == "cpu"


def _event(name, id_, start, end, device="cpu"):
    """A stand-in for a profiler ``FunctionEvent``."""
    dtype = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, id=id_, device_type=dtype,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_device_work_is_counted_by_the_range_that_launched_it():
    """Each kernel goes to the host range that holds its runtime call, found
    by their shared correlation id: also where the device's clock puts the
    kernel's start outside that range, and where the device-side annotation
    of a range, listed after the host range of the same name, spans other
    times (the rule that matched device starts against whichever of the two
    came last could put the kernel in no range)."""
    events = [
        _event("step:a", 1, 100, 200),
        _event("cudaLaunchKernel", 7, 110, 112),
        _event("aten::empty", 7, 105, 106),  # an op whose id collides: no runtime call
        _event("cuLaunchKernel", 8, 150, 151),
        _event("step:b", 2, 300, 400),
        _event("cudaLaunchKernel", 9, 310, 311),
        _event("cudaMemsetAsync", 10, 320, 321),
        # device work: K1 twice in a, once in b (its device start skewed past
        # b's host range), a fill in b, and the ranges' own device annotations
        _event("fused_inverse_kernel", 7, 120, 140, "cuda"),
        _event("fused_inverse_kernel", 8, 160, 180, "cuda"),
        _event("fused_inverse_kernel", 9, 401, 450, "cuda"),
        _event("fill", 10, 330, 331, "cuda"),
        _event("step:a", 1, 118, 181, "cuda"),
        _event("step:b", 2, 329, 399, "cuda"),
    ]
    ran = profiling.device_work_by_range(events, ["a", "b"])
    assert ran == {"a": {"fused_inverse_kernel": 2}, "b": {"fused_inverse_kernel": 1, "fill": 1}}
    # the old rule, device start against the last range listed, misses K1 in b
    last = {e.name[5:]: e.time_range for e in events if e.name.startswith("step:")}
    starts = [e.time_range.start for e in events if e.name == "fused_inverse_kernel"]
    assert not any(r.start <= starts[2] <= r.end for r in last.values())


def test_device_work_by_range_counts_by_card():
    """With a key of name and device, K1 launched once on each of two cards
    in one range counts once per card."""
    events = [_event("step:dp", 1, 100, 200), _event("cudaLaunchKernel", 7, 110, 111),
              _event("cudaLaunchKernel", 8, 120, 121), _event("cudaMemcpyAsync", 9, 130, 131)]
    for id_, index in ((7, 0), (8, 1)):
        events.append(_event("fused_inverse_kernel", id_, 140, 150, "cuda"))
        events[-1].device_index = index
    events.append(_event("Memcpy PtoP", 9, 160, 170, "cuda"))
    events[-1].device_index = 0
    ran = profiling.device_work_by_range(events, ["dp"], key=lambda e: (e.name, e.device_index))
    assert ran == {"dp": {("fused_inverse_kernel", 0): 1, ("fused_inverse_kernel", 1): 1,
                          ("Memcpy PtoP", 0): 1}}


@pytest.mark.parametrize("case", ["no launch", "outside", "missing range", "twice"])
def test_device_work_by_range_raises(case):
    events = [_event("step:a", 1, 100, 200), _event("cudaLaunchKernel", 7, 110, 112),
              _event("k", 7, 120, 130, "cuda")]
    labels = ["a"]
    if case == "no launch":
        events.append(_event("k", 99, 150, 160, "cuda"))
    elif case == "outside":
        events += [_event("cudaLaunchKernel", 8, 250, 251), _event("k", 8, 260, 270, "cuda")]
    elif case == "missing range":
        labels = ["a", "b"]
    else:
        events.append(_event("step:a", 3, 300, 400))
    with pytest.raises(ValueError):
        profiling.device_work_by_range(events, labels)


def test_device_work_by_range_on_a_cpu_trace(tmp_path):
    """A real trace on the CPU: both host ranges are found and nothing ran on
    a device."""
    with profiling.device_trace(str(tmp_path)) as prof:
        for label in ("x", "y"):
            with torch.profiler.record_function(f"step:{label}"):
                torch.ones(8).add_(1)
    assert profiling.device_work_by_range(list(prof.events()), ["x", "y"]) == {"x": {}, "y": {}}
