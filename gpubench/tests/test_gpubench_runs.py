"""Whole runs of each cell on the CPU at tiny sizes: sound runs are correct;
runs with the timed path broken underneath are not (the state returned
unchanged, half the batch left out, one answer altered where it is
produced; in a cell that tracks overflow, every flag flipped or no flags
returned); the control, the reference in a lower precision, is not; and
configurations, traffic mixes, cells and metric readers added as files pass
the same checks, through the same functions, as the cells of the manifest."""

import functools
import json
import re
import shutil
import time

import pytest
import torch

from gpubench import control
from gpubench.harness import inputs, manifest, program, runner
from gpubench.harness.trace import Session
from matrix_inversion_tpu_torch.runtime.api import BatchedMatrixInversion

CPU = torch.device("cpu")
CELLS = [w["name"] for w in manifest.load()["workloads"]]
TRACKED = [name for name in CELLS if runner.tracked(manifest.cell(name).config)]
#: the keys of a result line, without the traced run's ``breakdown``
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2**31 + 101
#: a CPU run's window holds this many warm calls of the cell's inversion at
#: its tiny size, after the profiled stretch where there is one, and lasts no
#: less than FLOOR_S
CALLS_A_WINDOW = 4
FLOOR_S = 0.3


@functools.cache
def window_s(name, root, small, traced):
    """The window of a CPU run of the cell ``name``: one warm ``run_raw`` of
    its configuration at its tiny batch, timed, times CALLS_A_WINDOW; in a
    traced run, after a profiled stretch timed as the drivers run it (calls
    under a profiler session for the traffic's ``trace_seconds``, then the
    session's stop, which takes longer the more the stretch recorded)."""
    cell, traffic = manifest.cell(name, root), small(name, root)
    cfg = cell.config
    io = cell.traffic.get("io", "packed")  # the float stream inverts in packed I/O
    inv = program.inverter(cfg, traffic["batch"], io, CPU)
    pool = inputs.float_pool(SEED, 1, traffic["batch"], cfg["n"], cfg["sampler"], CPU)
    args = inv.quantize(pool[0].numpy())
    inv.run_raw(*args)
    t = time.perf_counter()
    inv.run_raw(*args)
    seconds = max(FLOOR_S, CALLS_A_WINDOW * (time.perf_counter() - t))
    if traced:
        t = time.perf_counter()
        session = Session(False)
        while time.perf_counter() < t + traffic["trace_seconds"]:
            inv.run_raw(*args)
        session.stop()
        seconds += time.perf_counter() - t
    return seconds


def _run(name, small, trace=0, root=manifest.ROOT):
    return runner.run(name, SEED, window_s(name, root, small, bool(trace)), trace, 0.0,
                      device=CPU, root=root, traffic=small(name, root))


def check_sound(name, trace, small, root=manifest.ROOT):
    """A sound run of the cell is correct and reports its metrics; returns
    the result."""
    result, lines = _run(name, small, trace, root)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    cell = manifest.cell(name, root)
    checked = ["mismatched_cells"] + (["mismatched_flags"] if runner.tracked(cell.config) else [])
    assert lines[-len(checked):] == [f"check {k} 0 limit 0" for k in checked]
    assert list(result["checks"]) == checked
    assert [k for k in result if k != "breakdown"] == RESULT_KEYS
    expected = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in expected}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in expected}
    if not trace and cell.traffic["driver"] == "device_loop":
        # every call the loop made, the last ready past the close, over its time
        (note,) = [line for line in lines if line.startswith("inversions_per_s over ")]
        calls, last = re.match(r"inversions_per_s over (\d+) calls, the last ready ([\d.]+) s ",
                               note).groups()
        assert int(calls) == result["attempted"]
        assert float(last) > window_s(name, root, small, False) - 1e-6
        assert result["metrics"]["inversions_per_s"]["value"] == pytest.approx(
            result["attempted"] * small(name, root)["batch"] / float(last), rel=1e-5)
    json.dumps(result)
    return result


def _unchanged(run_raw):
    return lambda self, a, signs: (a, signs)


def _half(run_raw):
    def broken(self, a, signs):
        h = a.shape[0] // 2
        out = self._circuit(a[:h], signs[:h])

        def pad(t):
            return torch.cat([t, t.new_zeros((a.shape[0] - h,) + t.shape[1:])])
        return tuple(map(pad, out)) if isinstance(out, tuple) else pad(out)
    return broken


def _altered(run_raw):
    def broken(self, a, signs):
        out = run_raw(self, a, signs)
        first = out[0] if isinstance(out, tuple) else out
        first.view(-1)[0] ^= 1
        return out
    return broken


FAULTS = [_unchanged, _half, _altered]


def check_fault(name, fault, small, monkeypatch, root=manifest.ROOT):
    """A run of the cell with ``fault`` planted under its timed path is not
    correct."""
    window_s(name, root, small, False)  # timed on the sound path, before the fault goes in
    with monkeypatch.context() as patch:
        patch.setattr(BatchedMatrixInversion, "run_raw", fault(BatchedMatrixInversion.run_raw))
        result, lines = _run(name, small, root=root)
    assert not result["correct"] and result["failed"] > 0
    assert result["checks"]["mismatched_cells"]["value"] > 0
    (line,) = [line for line in lines if line.startswith("check mismatched_cells ")]
    assert not line.endswith(" 0 limit 0")


def check_control(name, small, root=manifest.ROOT):
    """The reference in the configuration's control format, in the program's
    place, is not correct, where the reference itself is."""
    got = control.readings(name, SEED, CPU, root=root, traffic=small(name, root))
    assert got["sound"] == 0 and got["cells"] > 0
    assert got["control"] > 0


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, trace, small):
    check_sound(name, trace, small)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, small, monkeypatch):
    check_fault(name, fault, small, monkeypatch)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, small):
    check_control(name, small)


def _flipped(run_raw):
    def broken(self, a, signs):
        mags, signs_out, flags = run_raw(self, a, signs)
        return mags, signs_out, 1 - flags
    return broken


def _no_flags(run_raw):
    return lambda self, a, signs: run_raw(self, a, signs)[:2]


@pytest.mark.parametrize("fault", [_flipped, _no_flags], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", TRACKED)
def test_broken_flags_are_not_correct(name, fault, small, monkeypatch):
    """The inverse right and every flag wrong, or missing: every sampled
    matrix counts, and the answers' cells still match."""
    window_s(name, manifest.ROOT, small, False)
    with monkeypatch.context() as patch:
        patch.setattr(BatchedMatrixInversion, "run_raw", fault(BatchedMatrixInversion.run_raw))
        result, lines = _run(name, small)
    matrices = small(name, manifest.ROOT)["batch"] * min(
        small(name, manifest.ROOT)["keep_outputs"], result["attempted"])
    assert not result["correct"] and result["failed"] > 0
    assert result["checks"]["mismatched_cells"]["value"] == 0
    assert result["checks"]["mismatched_flags"]["value"] == matrices
    assert lines[-1] == f"check mismatched_flags {matrices} limit 0"


def test_the_tracked_cell_is_there():
    assert TRACKED == ["high_n4_tracked.device"]
    assert manifest.cell(TRACKED[0]).traffic["io"] == "packed"


def _add_files(root):
    """Two configurations, a traffic mix, two cells and a metric reader added
    to the checkout at ``root`` as files and appended manifest entries: LOW
    at n = 3, and HIGH at n = 13, the smallest n that "auto" sends down the
    op-by-op path on the card, whose file has no K1 keys."""
    config = json.loads((root / "gpubench/configs/high_n4.json").read_text())
    config.update(name="low_n3", n=3, qfloat_len=23, qfloat_ints=9, true_division=False)
    (root / "gpubench/configs/low_n3.json").write_text(json.dumps(config))
    traffic = dict(json.loads((root / "gpubench/traffic/packed_b262144.json").read_text()),
                   batch=40, pool=2, warm_calls=1, keep_outputs=2, trace_seconds=0.2)
    (root / "gpubench/traffic/packed_b40.json").write_text(json.dumps(traffic))
    (root / "gpubench/metrics/calls_seen.py").write_text(
        "def read(cell, win):\n    return float(len(win.spans['run_raw_host']))\n")
    config = json.loads((root / "gpubench/configs/high_n10.json").read_text())
    for key in ("k1_kernels", "roofline"):
        del config[key]
    config.update(name="high_n13", n=13)
    (root / "gpubench/configs/high_n13.json").write_text(json.dumps(config))

    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"] += [
        {"name": "low_n3", "source": "https://example.org/low", "reduced": [],
         "file": "gpubench/configs/low_n3.json", "why": "a test"},
        {"name": "high_n13", "source": "https://example.org/high", "reduced": [],
         "file": "gpubench/configs/high_n13.json", "why": "a test of the op-by-op path"}]
    m["workloads"] += [
        {"name": "low_n3.device", "config": "low_n3", "traffic": "packed_b40", "chips": 1,
         "why": "a test"},
        {"name": "high_n13.device", "config": "high_n13", "traffic": "packed_b262144",
         "chips": 1, "why": "a test of the op-by-op path"}]
    op_by_op = ("inversions_per_s", "call_p95_ms", "run_raw_host_ms", "idle_pct",
                "run_raw_lead_us", "run_raw_launches", "setup_library_s")
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] in ("inversions_per_s", "call_p95_ms"):
            e["workloads"].append("low_n3.device")
        if e["name"] in op_by_op:
            e["workloads"].append("high_n13.device")
    m["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "runtime api",
                           "moves": "call_p95_ms", "workloads": ["low_n3.device"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def test_a_cell_a_config_and_a_metric_are_added_as_files(tmp_path, small, required_keys,
                                                          monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    _add_files(root)
    changed = {p.relative_to(root) for p, data in before.items() if p.read_bytes() != data}
    assert {str(p) for p in changed} == {"BENCHMARK.json"}

    result = check_sound("low_n3.device", 0, small, root)
    assert set(result["metrics"]) == {"inversions_per_s", "call_p95_ms", "setup_s"}
    result = check_sound("low_n3.device", 1, small, root)
    assert result["metrics"]["calls_seen"]["value"] > 0

    name = "high_n13.device"
    cell = manifest.cell(name, root)
    assert not {"k1_kernels", "roofline"} & set(cell.config)
    assert all(k in cell.config for k in required_keys(cell, root))
    assert small(name, root)["batch"] <= 6
    for trace in (0, 1):
        check_sound(name, trace, small, root)
    for fault in FAULTS:
        check_fault(name, fault, small, monkeypatch, root)
    check_control(name, small, root)
