"""BENCHMARK.json and the files it names: the allowed characters, the keys,
and every cross-reference."""

import json
import re

import pytest

from gpubench.harness import manifest

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]
LINE = re.compile(r"[^\n\t]{1,200}")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= len(M["paths"]) <= 16
    for path in M["paths"]:
        assert manifest.PATH.fullmatch(path) and not path.startswith("/") and ".." not in path
        assert (manifest.ROOT / path).is_dir()
    for word in M["command"]:
        assert LINE.fullmatch(word) and not word.startswith("/") and ".." not in word
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    named = M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]
    for entry in named:
        assert manifest.NAME.fullmatch(entry["name"]), entry["name"]
    for w in M["workloads"]:
        assert manifest.NAME.fullmatch(w["config"]) and manifest.NAME.fullmatch(w["traffic"])
    for c in M["configs"]:
        assert all(manifest.NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"])
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


def test_configs_workloads_and_metrics_cross_reference():
    configs = {c["name"]: c for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    assert {w["config"] for w in M["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in M["per_layer"]:
        assert (manifest.BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert manifest.applies(moved, cell), (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_with_its_files(name, required_keys):
    cell = manifest.cell(name)
    assert (manifest.BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    assert [k for k in required_keys(cell) if k not in cell.config] == []
    assert cell.config["control"]["qfloat_len"] < cell.config["qfloat_len"]


def test_a_config_key_is_required_where_a_metric_reads_it(required_keys):
    def cell(*metrics):
        return manifest.Cell(name="x", config={}, traffic={}, end_to_end=[], chips=1,
                             per_layer=[{"name": m} for m in metrics])

    always = {"n", "qfloat_len", "qfloat_ints", "qfloat_base", "true_division", "sampler",
              "control", "source"}
    assert set(required_keys(cell("stream_idle_pct", "setup_library_s"))) == always
    assert set(required_keys(cell("k1_roofline_pct"))) == always | {"roofline"}
    assert set(required_keys(cell("digit_io_ms", "idle_pct"))) == always | {"k1_kernels"}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        manifest.cell("no_such.cell")
