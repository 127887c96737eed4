"""Port vs JAX package: the user's tools above the API.

``utils/debug.py`` (``run_qfloat_inverse``, ``compare_plu``,
``debug_inverse``, whose Y and X come from ``qfloat_lu_inverse(debug=True)``)
and ``precision_benchmark`` are held exactly to the JAX package's on the
same matrices; ``time_benchmark``'s keys and log file, the CLI's output
lines (``python -m matrix_inversion_tpu_torch --device cpu``, with and
without ``--simulate``), and the keys of the throughput, e2e and precision
runners of ``utils/run_benchmarks.py`` at a tiny batch on the CPU.  Without
a card, every entry point that defaults to it raises.
"""

import json

import numpy as np
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import qfloat_lu as jax_qfloat_lu
from matrix_inversion_tpu.utils import debug as jax_debug
from matrix_inversion_tpu.utils import precision as jax_precision

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch import __main__ as cli
from matrix_inversion_tpu_torch.models import marshal, qfloat_lu
from matrix_inversion_tpu_torch.utils import debug, precision, run_benchmarks

torch.set_num_threads(2)

P3 = (mi.LOW.replace(n=3), mt.LOW.replace(n=3))


@pytest.fixture(scope="module")
def matrix():
    return np.random.RandomState(11).randn(3, 3) * 100


def test_run_qfloat_inverse_matches_jax(matrix):
    got = debug.run_qfloat_inverse(matrix, P3[1], device="cpu")
    np.testing.assert_array_equal(got, jax_debug.run_qfloat_inverse(matrix, P3[0]))
    assert got.shape == (3, 3) and np.mean(np.abs(got - np.linalg.inv(matrix))) < 1e-2


def test_compare_plu_matches_jax(matrix, capsys):
    got = debug.compare_plu(matrix, P3[1], device="cpu")
    ref = jax_debug.compare_plu(matrix, P3[0], verbose=False)
    assert "QFloat L :" in capsys.readouterr().out
    for name in ("P", "L", "U"):
        for g, r in zip(got[name], ref[name]):
            np.testing.assert_array_equal(g, r)
    assert got["max_dev"] == ref["max_dev"]
    assert got["max_dev"]["P"] == 0 and got["max_dev"]["U"] < 0.5


def test_debug_inverse_matches_jax(matrix):
    got = debug.debug_inverse(matrix, P3[1], verbose=False, device="cpu")
    ref = jax_debug.debug_inverse(matrix, P3[0], verbose=False)
    assert sorted(got) == ["L", "U", "X", "Y"]
    for name in got:
        assert got[name][0] == ref[name][0]
        np.testing.assert_array_equal(got[name][1], ref[name][1])


def test_lu_inverse_debug_returns_y_and_x(matrix):
    """``qfloat_lu_inverse(debug=True)`` gives ``(Minv, Y, X)``, Minv the
    same cells as without ``debug`` and the transpose of X."""
    p = P3[1]
    d, s = marshal.float_matrix_to_qfloat_arrays(matrix, p.qfloat_len, p.qfloat_ints, 2)
    M = marshal.qfloat_arrays_to_qfloat_matrix(torch.from_numpy(d), torch.from_numpy(s),
                                               p.qfloat_ints, 2, backend="packed")
    P, L, U = qfloat_lu.qfloat_lu_decomposition(M, p.qfloat_len, p.qfloat_ints)
    plain = qfloat_lu.qfloat_lu_inverse(P, L, U, p.qfloat_len, p.qfloat_ints)
    Minv, Y, X = qfloat_lu.qfloat_lu_inverse(P, L, U, p.qfloat_len, p.qfloat_ints, debug=True)
    for i in range(3):
        for j in range(3):
            assert torch.equal(Minv[i][j].mag, plain[i][j].mag)
            assert Minv[i][j] is X[j][i]
    assert len(Y) == 3 and all(len(row) == 3 for row in Y)
    assert qfloat_lu.map_2D_list([[1, 2]], lambda x: -x) == \
        jax_qfloat_lu.map_2D_list([[1, 2]], lambda x: -x)


def test_debug_tools_need_packed(matrix):
    with pytest.raises(NotImplementedError, match="item 7b"):
        debug.compare_plu(matrix, P3[1], backend="limb", device="cpu")
    with pytest.raises(NotImplementedError, match="item 7b"):
        debug.run_qfloat_inverse(matrix, P3[1], backend="limb", device="cpu")


def test_precision_benchmark_matches_jax():
    """LOW n=2, N = 100 in batches of 32: the last batch is padded, and the
    stats equal JAX's."""
    got = precision.precision_benchmark(mt.LOW.replace(n=2), N=100, batch_size=32,
                                        device="cpu")
    ref = jax_precision.precision_benchmark(mi.LOW.replace(n=2), N=100, batch_size=32)
    assert got == ref
    errors = precision.precision_errors(mt.LOW.replace(n=2), N=100, batch_size=32,
                                        device="cpu")
    assert errors.shape == (100,) and float(np.mean(errors)) == got["mean_error"]


def test_time_benchmark_keys_and_log(tmp_path):
    log = tmp_path / "times.txt"
    log.write_text("stale\n")
    got = precision.time_benchmark(mt.LOW, values_n=(2, 3), filename=str(log), reps=2,
                                   batch_size=8, device="cpu")
    assert sorted(got) == [2, 3]
    for stats in got.values():
        assert sorted(stats) == ["compile_s", "inversions_per_s", "mean_run_s"]
        assert stats["mean_run_s"] > 0 and stats["inversions_per_s"] == 8 / stats["mean_run_s"]
    text = log.read_text()
    assert "stale" not in text
    assert text.startswith("Benchmark for n = 2\ncompilation :")
    assert text.count("running     :") == 4 and text.count("\nmean :") == 2
    assert "Benchmark for n = 3\n" in text


@pytest.mark.parametrize("flags", [[], ["--simulate"], ["--batch", "3"]],
                         ids=["run", "simulate", "batch"])
def test_cli_output_lines(flags, capsys):
    cli.main(["--sizes", "2,3", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    for title in ("Sampler=Normal, N=2", "Sampler=Normal, N=3", "Sampler=Uniform, N=2",
                  "Sampler=Uniform, N=3"):
        assert f"\n{title}\n{'-' * len(title)}\nCompiling...\n(took " in out
    for line in ("Generating Keys...", "Running...", "Average Error: ", "    Max Error: ",
                 "    Min Error: ", "  Total Error: "):
        assert out.count(line) == 4
    errors = [float(line.split(":")[1]) for line in out.splitlines()
              if line.startswith("Average Error:")]
    assert len(errors) == 4 and all(np.isfinite(errors))


def test_card_is_the_default():
    """Without a card every tool that defaults to it raises; none runs on
    the CPU unless asked to."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    M = np.eye(2)
    for call in (lambda: cli.main(["--sizes", "2"]),
                 lambda: debug.run_qfloat_inverse(M, mt.LOW.replace(n=2)),
                 lambda: debug.compare_plu(M, mt.LOW.replace(n=2)),
                 lambda: debug.debug_inverse(M, mt.LOW.replace(n=2)),
                 lambda: precision.precision_benchmark(mt.LOW.replace(n=2), N=4),
                 lambda: precision.time_benchmark(mt.LOW),
                 lambda: run_benchmarks.throughput(4),
                 lambda: run_benchmarks.e2e(batch=4)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def test_throughput_keys():
    got = run_benchmarks.throughput(batch=4, reps=1, device="cpu")
    assert sorted(got) == ["high/n=4", "high/n=5", "low/n=2", "medium/n=3"]
    for entry in got.values():
        assert sorted(entry) == ["batch", "elapsed_s", "inversions_per_s", "reps"]
        assert entry["batch"] == 4 and entry["reps"] == 1 and entry["inversions_per_s"] > 0


def test_e2e_keys():
    got = run_benchmarks.e2e(preset="low", n=2, batch=8, nbatches=2, repeats=2, device="cpu")
    assert got["config"] == "low/n=2" and got["platform"] == "cpu" and got["batch"] == 8
    assert got["n_batches_streamed"] == 2 and "methodology_note" in got and "date" in got
    for label in ("native", "numpy"):
        for key in ("quantize_s_per_batch", "dequantize_s_per_batch",
                    "serial_est_no_transfer_inversions_per_s",
                    "serial_measured_inversions_per_s", "streamed_inversions_per_s",
                    "streamed_over_serial_measured"):
            assert got[f"{label}/{key}"] > 0
        for key in ("quantize_s_per_batch_all", "dequantize_s_per_batch_all",
                    "serial_measured_inversions_per_s_all", "streamed_inversions_per_s_all"):
            assert len(got[f"{label}/{key}"]) == 2
    assert len(got["device_only_inversions_per_s_all"]) == 2
    assert got["streamed_fraction_of_device_rate"] > 0
    json.dumps(got)


def test_precision_table_keys(capsys):
    got = run_benchmarks.precision(N=10, sizes=(2,), presets=("low",), batch=8, device="cpu")
    assert list(got) == ["low/n=2"]
    assert got["low/n=2"]["N"] == 10 and got["low/n=2"]["wall_s"] > 0
    assert "low 2 {" in capsys.readouterr().out
