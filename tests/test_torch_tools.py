"""Port vs JAX package: the user's tools above the API.

``utils/debug.py`` (``run_qfloat_inverse``, ``compare_plu``,
``debug_inverse``, whose Y and X come from ``qfloat_lu_inverse(debug=True)``)
and ``precision_benchmark`` are held exactly to the JAX package's on the
same matrices; ``time_benchmark``'s keys and log file, the CLI's output
lines (``python -m matrix_inversion_tpu_torch --device cpu``, with and
without ``--simulate``), and the keys of the throughput, e2e, precision,
lowering, fused and rooflines runners of ``utils/run_benchmarks.py`` at a
tiny batch on the CPU (e2e also with the stream's card route forced on, the
float-I/O kernels' host form in place of their launches).  Without
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
from matrix_inversion_tpu_torch.runtime import stream as stream_module
from matrix_inversion_tpu_torch.utils import debug, precision, profiling, roofline, run_benchmarks

import float_io_host

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
    """The tools take the limb backend too, and agree with the packed one."""
    np.testing.assert_array_equal(
        debug.run_qfloat_inverse(matrix, P3[1], backend="limb", device="cpu"),
        debug.run_qfloat_inverse(matrix, P3[1], backend="packed", device="cpu"))
    limb = debug.compare_plu(matrix, P3[1], backend="limb", verbose=False, device="cpu")
    packed_ = debug.compare_plu(matrix, P3[1], backend="packed", verbose=False, device="cpu")
    for key in ("P", "L", "U"):
        np.testing.assert_array_equal(np.asarray(limb[key][0], float),
                                      np.asarray(packed_[key][0], float))


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


def test_e2e_times_the_card_route_once(monkeypatch, tmp_path):
    """Where the stream quantizes and dequantizes on the card (forced on here
    for packed I/O on the CPU, the kernels' host form in place of their
    launches), its rate is taken once, under ``card/``, and set against each
    host route's serial pipeline; no host route claims a streamed rate."""
    float_io_host.kernel_route(monkeypatch, float_io_host.build(tmp_path))
    monkeypatch.setattr(stream_module, "_marshals_on_device", lambda inv: inv.io == "packed")
    profiling.reset()
    got = run_benchmarks.e2e(preset="high", n=2, batch=8, nbatches=2, repeats=2, device="cpu")
    assert profiling.counters("stream.") == {"stream.device_marshal": 4}
    card = got["card/streamed_inversions_per_s"]
    assert card > 0 and len(got["card/streamed_inversions_per_s_all"]) == 2
    assert got["streamed_fraction_of_device_rate"] == card / got["device_only_inversions_per_s"]
    assert "not an overlap A/B" in got["methodology_note"]
    for label in ("native", "numpy"):
        serial = got[f"{label}/serial_measured_inversions_per_s"]
        assert got[f"card/streamed_over_{label}_serial_measured"] == card / serial
        for key in ("streamed_inversions_per_s", "streamed_inversions_per_s_all",
                    "streamed_over_serial_measured"):
            assert f"{label}/{key}" not in got
    json.dumps(got)


def test_precision_table_keys(capsys):
    got = run_benchmarks.precision(N=10, sizes=(2,), presets=("low",), batch=8, device="cpu")
    assert list(got) == ["low/n=2"]
    assert got["low/n=2"]["N"] == 10 and got["low/n=2"]["wall_s"] > 0
    assert "low 2 {" in capsys.readouterr().out


def test_lowering_keys_and_equal_outputs():
    got = run_benchmarks.lowering(sizes=(2, 3), batch=4, reps=1, repeats=1, device="cpu")
    assert sorted(got) == ["n=2/fused", "n=2/unroll", "n=3/fused", "n=3/unroll"]
    for entry in got.values():
        assert entry["first_call_s"] > 0 and entry["inversions_per_s"] > 0
        assert entry["libraries_built"] is None and entry["platform"] == "cpu"
        assert entry["batch"] == 4 and entry["reps"] == 1
    json.dumps(got)


def test_lowering_raises_when_the_lowerings_differ(monkeypatch):
    run_raw = mt.BatchedMatrixInversion.run_raw

    def off_by_one(self, mags, signs):
        out = run_raw(self, mags, signs)
        return (out[0] + 1, out[1]) if self.params.lowering == "unroll" else out

    monkeypatch.setattr(mt.BatchedMatrixInversion, "run_raw", off_by_one)
    with pytest.raises(RuntimeError, match="unroll lowering's output differs"):
        run_benchmarks.lowering(sizes=(2,), batch=4, reps=1, repeats=1, device="cpu")


def test_fused_keys_and_rooflines():
    rates = {"u32_kernelmix": 1e13}
    got = run_benchmarks.fused(sizes=(2, 3), batch=4, reps=1, repeats=2, tracked=True,
                               unroll_sizes=(2,), rates=rates, device="cpu")
    assert sorted(got) == ["high/n=2/fused", "high/n=2/fused_tracked", "high/n=2/unroll_tracked",
                           "high/n=3/fused", "high/n=3/fused_tracked"]
    for key, entry in got.items():
        assert entry["inversions_per_s"] > 0 and entry["first_call_s"] > 0
        assert entry["batch"] == 4 and len(entry["chain_reps"]["elapsed_all_s"]) == 2
        assert ("mfu_pct_vs_measured_roofline" in entry) == key.endswith("/fused")
    for n in (2, 3):
        roof = roofline_of(n, got[f"high/n={n}/fused"]["inversions_per_s"], rates)
        entry = got[f"high/n={n}/fused"]
        assert entry["ops_per_inversion_kernel"] == roof["ops_per_inversion_kernel"]
        assert entry["mfu_pct_vs_measured_roofline"] == roof["mfu_pct_vs_measured_roofline"]
    table = run_benchmarks.rooflines(got)
    assert list(table) == ["n=2", "n=3"]
    for n, row in zip((2, 3), table.values()):
        assert row["measured_inversions_per_s"] == got[f"high/n={n}/fused"]["inversions_per_s"]
        bound = row["roofline_inversions_per_s_measured_rates"]
        assert row["mfu_pct_dispatched"] == round(100 * row["measured_inversions_per_s"] / bound, 2)
        assert row["int_issue_rate"] == 1e13
        assert "kernel_op_histogram" not in row
    tracked = run_benchmarks.rooflines(got, track=True)
    assert (tracked["n=2"]["measured_inversions_per_s"]
            == got["high/n=2/fused_tracked"]["inversions_per_s"])
    # a bound that the measured rate beats raises: no share is capped
    with pytest.raises(ValueError, match="n=2"):
        run_benchmarks.rooflines(got, rates={"u32_kernelmix": 1e4})


def roofline_of(n, rate, rates):
    return roofline.kernel_roofline(rate, n, "high", {"default": rates["u32_kernelmix"]})


def test_new_drivers_default_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: run_benchmarks.lowering(sizes=(2,), batch=4),
                 lambda: run_benchmarks.fused(sizes=(2,), batch=4)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    run_benchmarks.main(["--device", "cpu", "rooflines", "--sizes", "2", "--batch", "4",
                         "--reps", "1", "--repeats", "1"])
    table = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(table) == ["n=2"] and table["n=2"]["rate_source"] == "none"
