"""What a run may load and where it may run: no file of the benchmark imports
JAX, its relatives or the JAX package (top-level names compared whole), the
reference imports nothing of the program, a process that holds JAX once the
window has closed prints no result, and a run needs a card and the program."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpubench.harness import imports, manifest, runner

FILES = sorted(manifest.BENCH.rglob("*.py"))


def test_the_check_compares_top_level_names_whole():
    names = ["matrix_inversion_tpu_torch", "matrix_inversion_tpu_torch.ops.packed", "jaxtyping",
             "numpy", "flaxen"]
    assert imports.forbidden_loaded(names) == []
    assert imports.forbidden_loaded(names + ["jax.numpy", "matrix_inversion_tpu.ops"]) == [
        "jax", "matrix_inversion_tpu"]
    assert imports.forbidden_loaded(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert imports.forbidden_loaded(imports.imported_names(path)) == []


@pytest.mark.parametrize("path", sorted((manifest.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {imports.top(name) for name in imports.imported_names(path)}
    assert tops <= {"torch", "__future__"}, tops
    tree = ast.parse(path.read_text())
    assert all(node.level <= 1 for node in ast.walk(tree) if isinstance(node, ast.ImportFrom))


def test_a_run_importing_nothing_forbidden_holds_nothing_forbidden():
    # this process imports the harness, the reference and the program
    assert imports.forbidden_loaded() == []


def test_a_process_holding_jax_prints_no_result(monkeypatch, capsys, small):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    real_run = runner.run
    monkeypatch.setattr(runner, "run", lambda *a, **k: real_run(
        *a, device=torch.device("cpu"), traffic=small("high_n4.device"), **k))
    code = runner.main(["--workload", "high_n4.device", "--seed", "5", "--seconds", "0.2"], 0.0)
    out, err = capsys.readouterr()
    assert code != 0 and out == "" and "jax" in err


def test_a_forbidden_module_loaded_by_the_check_prints_no_result(monkeypatch, capsys, small):
    real_run, real_compare = runner.run, runner.compare

    def compare(*a, **k):
        monkeypatch.setitem(sys.modules, "matrix_inversion_tpu.ops", type(sys)("ops"))
        return real_compare(*a, **k)

    monkeypatch.setattr(runner, "compare", compare)
    monkeypatch.setattr(runner, "run", lambda *a, **k: real_run(
        *a, device=torch.device("cpu"), traffic=small("high_n4.device"), **k))
    code = runner.main(["--workload", "high_n4.device", "--seed", "5", "--seconds", "0.2"], 0.0)
    out, err = capsys.readouterr()
    assert code != 0 and out == "" and "matrix_inversion_tpu" in err


def _command(cwd, env=None):
    cmd = [sys.executable, "gpubench/run.py", "--workload", "high_n4.device", "--seed",
           str(2**31 + 11), "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = _command(manifest.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_bytes((manifest.ROOT / "BENCHMARK.json").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _command(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "matrix_inversion_tpu_torch" in proc.stderr


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    proc = _command(manifest.ROOT)
    assert proc.returncode == 0, proc.stderr
    import json

    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1] == "check mismatched_cells 0 limit 0"
    assert Path(manifest.ROOT, "matrix_inversion_tpu_torch", "_build").is_dir()
