"""Whole runs of each cell on the CPU at tiny sizes: sound runs are correct;
runs with the timed path broken underneath are not (the state returned
unchanged, half the batch left out, one answer altered where it is
produced); the control, the reference in a lower precision, is not; and a
new configuration, traffic mix and metric reader work as added files."""

import json
import shutil

import pytest
import torch

from gpubench import control
from gpubench.harness import manifest, runner
from matrix_inversion_tpu_torch.runtime.api import BatchedMatrixInversion

CPU = torch.device("cpu")
CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2**31 + 101


def _run(name, small, trace=0, **kw):
    seconds = 2.0 if name == "high_n10.device" else 0.3  # a CPU call at n=10 takes ~0.5 s
    return runner.run(name, SEED, seconds, trace, 0.0, device=CPU, traffic=small[name], **kw)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, trace, small):
    result, lines = _run(name, small, trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert lines[-1] == "check mismatched_cells 0 limit 0"
    assert list(result)[-1] == "checks"
    cell = manifest.cell(name)
    expected = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in expected}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in expected}
    json.dumps(result)


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


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, small, monkeypatch):
    monkeypatch.setattr(BatchedMatrixInversion, "run_raw",
                        fault(BatchedMatrixInversion.run_raw))
    result, lines = _run(name, small)
    assert not result["correct"] and result["failed"] > 0
    assert result["checks"]["mismatched_cells"]["value"] > 0
    assert lines[-1].startswith("check mismatched_cells ")
    assert not lines[-1].endswith(" 0 limit 0")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, small):
    got = control.readings(name, SEED, CPU, traffic=small[name])
    assert got["sound"] == 0 and got["cells"] > 0
    assert got["control"] > 0


def test_a_cell_a_config_and_a_metric_are_added_as_files(tmp_path, small):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    config = json.loads((root / "gpubench/configs/high_n4.json").read_text())
    config.update(name="low_n3", n=3, qfloat_len=23, qfloat_ints=9, true_division=False)
    (root / "gpubench/configs/low_n3.json").write_text(json.dumps(config))
    traffic = dict(json.loads((root / "gpubench/traffic/packed_b262144.json").read_text()),
                   batch=40, pool=2, warm_calls=1, keep_outputs=2, trace_seconds=0.2)
    (root / "gpubench/traffic/packed_b40.json").write_text(json.dumps(traffic))
    (root / "gpubench/metrics/calls_seen.py").write_text(
        "def read(cell, win):\n    return float(len(win.spans['run_raw_host']))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "low_n3", "source": "https://example.org/low", "reduced": [],
                         "file": "gpubench/configs/low_n3.json", "why": "a test"})
    m["workloads"].append({"name": "low_n3.device", "config": "low_n3", "traffic": "packed_b40",
                           "chips": 1, "why": "a test"})
    for e in m["end_to_end"]:
        if e["name"] in ("inversions_per_s", "call_p95_ms"):
            e["workloads"].append("low_n3.device")
    m["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "runtime api",
                           "moves": "call_p95_ms", "workloads": ["low_n3.device"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    changed = {p.relative_to(root) for p, data in before.items() if p.read_bytes() != data}
    assert {str(p) for p in changed} == {"BENCHMARK.json"}
    result, _ = runner.run("low_n3.device", SEED, 0.3, 0, 0.0, device=CPU, root=root)
    assert result["correct"]
    assert set(result["metrics"]) == {"inversions_per_s", "call_p95_ms", "setup_s"}
    result, _ = runner.run("low_n3.device", SEED, 1.0, 1, 0.0, device=CPU, root=root)
    assert result["correct"] and result["metrics"]["calls_seen"]["value"] > 0
