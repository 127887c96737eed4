"""The port's roofline (utils/roofline.py) and op counters on the CPU.

The cases of tests/test_roofline.py on torch tensors, the histogram of the
fused kernel's emitted body, the measured-rate roofline and its per-n
table; and the QFloat op counters of the port against the JAX package's on
the same circuits.
"""

import functools

import jax.numpy as jnp
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models.inverse import (
    qfloat_matrix_inverse_packed_io as jax_inverse_packed_io,
)
from matrix_inversion_tpu.utils.profiling import circuit_stats as jax_circuit_stats

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core.qfloat import QFloatBase
from matrix_inversion_tpu_torch.ops import emit
from matrix_inversion_tpu_torch.utils import roofline
from matrix_inversion_tpu_torch.utils.profiling import circuit_stats
from matrix_inversion_tpu_torch.utils.roofline import (
    count_u32_ops,
    flagship_roofline,
    kernel_op_histogram,
    kernel_roofline,
    rooflines,
)

torch.set_num_threads(2)


def test_counts_simple_ops():
    def f(x, y):
        return x + y * y  # one add + one mul, 8 elements each

    x = torch.zeros(8, dtype=torch.int32)
    assert count_u32_ops(f, x, x) == 16.0


def test_s64_weighting():
    def f(x):
        return x + x

    x32 = torch.zeros(4, dtype=torch.int32)
    x64 = torch.zeros(4, dtype=torch.int64)
    assert count_u32_ops(f, x32) == 4.0
    assert count_u32_ops(f, x64) == 8.0        # floor: int64 = 2x
    assert count_u32_ops(f, x64, realistic=True) == 12.0  # add = 3 32-bit ops


def test_loop_multiplies_by_length():
    def f(x):
        ys = []
        for _ in range(10):
            ys.append(x * x)
            x = x + 1
        return x, ys

    x = torch.zeros(4, dtype=torch.int32)
    # per step: add(4) + mul(4) = 8; 10 steps
    assert count_u32_ops(f, x) == 80.0


def test_data_movement_costs_nothing():
    def f(x):
        y = x.reshape(2, 4).t().contiguous().to(torch.int64)
        return torch.cat([y, y]).expand(2, 8, 2)[..., 0].clone()

    assert count_u32_ops(f, torch.zeros(8, dtype=torch.int32)) == 0.0


def test_inplace_shift_compare_and_select_count():
    def f(x):
        x = x.clone()
        x += 1                                   # add, 4 x int64
        y = (x >> 3) & 7                         # shift, and
        return torch.where(x > y, x, y)          # compare (bool), select

    x = torch.zeros(4, dtype=torch.int64)
    assert count_u32_ops(f, x) == 4 * (2 + 2 + 2 + 1 + 2)
    assert count_u32_ops(f, x, realistic=True) == 4 * (3 + 4 + 2 + 1 + 2)


def test_flagship_roofline_reports():
    r = flagship_roofline(batch=8, measured_inversions_per_s=1e6)
    assert r["ops_per_inversion_u32eq_floor"] > 1000
    assert (
        r["ops_per_inversion_u32eq_realistic"]
        > r["ops_per_inversion_u32eq_floor"]
    )
    assert r["mfu_pct_vs_realistic"] > r["mfu_pct_vs_upper"] > 0
    assert r["int_ops_per_s"] == roofline.PUBLISHED_INT32_RATE_H100 == 132 * 64 * 1.98e9
    assert list(r)[:5] == [
        "ops_per_inversion_u32eq_floor", "ops_per_inversion_u32eq_realistic",
        "int_ops_per_s", "roofline_inversions_per_s_upper",
        "roofline_inversions_per_s_realistic",
    ]
    half = flagship_roofline(batch=8, int_ops_per_s=r["int_ops_per_s"] / 2)
    assert "mfu_pct_vs_upper" not in half
    assert half["roofline_inversions_per_s_upper"] == pytest.approx(
        r["roofline_inversions_per_s_upper"] / 2, rel=1e-6)


def test_kernel_histogram_high_n4():
    """HIGH n=4: 50 multiplies, 22 divisions, 110 signed adds; the tracked
    body takes the tracked primitives and ORs 182 flags."""
    h = kernel_op_histogram(4, "high")
    assert h["mul"] == 50 and h["sadd"] == 110
    assert h.get("divide", 0) + h.get("invert", 0) == 22
    assert "flag_or" not in h and not any(k.endswith("_t") for k in h)
    assert list(h.values()) == sorted(h.values(), reverse=True)
    t = kernel_op_histogram(4, "high", track=True)
    assert t["flag_or"] == 182
    assert t["mul_window_t"] == 50 and t["sadd_t"] == 110 and t["divide_t"] == 22
    assert t["int"] == h["int"] and t["gt"] == h["gt"] == t["blend"] == h["blend"]


@pytest.mark.parametrize("preset,n,track", [
    ("high", 2, False), ("high", 3, False), ("high", 5, True),
    ("low", 3, False), ("low", 4, True), ("medium", 3, False),
])
def test_histogram_counts_every_statement(preset, n, track):
    """The tally accounts for every statement of the emitted body: one per
    primitive call or int statement, one per flag OR, two stores per cell
    (and the tracked body's flag declaration and return)."""
    p = mt.PRESETS[preset].replace(n=n)
    em = emit.emit_circuit(p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
                           p.true_division, track)
    assert sum(em.ops.values()) + 2 * n * n == len(em.lines)
    assert dict(em.ops) == {k: v for k, v in kernel_op_histogram(n, preset, track).items()}
    assert set(em.ops) <= set(roofline._PRIM_NOMINAL_INSTR)
    body = emit.emit_body(p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
                          p.true_division, track)
    for prim in ("mul", "sadd", "divide", "invert", "gt", "blend", "set_len_ints",
                 "sadd_t", "mul_window_t", "divide_t", "invert_t", "sb_div_mag"):
        calls = sum(line.split(" = ")[1].startswith((prim + "<", prim + "("))
                    for line in body.splitlines() if " = " in line)
        assert calls == em.ops.get(prim, 0), prim
    assert body.count("ovf |=") == em.ops.get("flag_or", 0)


def test_kernel_roofline_without_rates_has_no_bound():
    r = kernel_roofline(measured_inversions_per_s=1e9, n=4, preset="high")
    assert r["rate_source"] == "none"
    assert r["ops_per_inversion_kernel"] == sum(r["kernel_op_histogram"].values())
    assert r["nominal_instructions_per_inversion"] > r["ops_per_inversion_kernel"]
    assert not any("roofline" in k or "mfu" in k or "rate" in k.replace("rate_source", "")
                   for k in r)


def test_kernel_roofline_with_rates_is_count_over_rate():
    """Over the function's histogram: the emitted body's less P.M's chains
    (16 * 2 signed adds at n = 4, tests/test_torch_k1_lanes.py)."""
    hist = roofline.function_op_histogram(4, "high")
    assert hist["sadd"] == kernel_op_histogram(4, "high")["sadd"] - 32 == 78
    rates = {prim: 1e9 * (i + 1) for i, prim in enumerate(hist)}
    r = kernel_roofline(measured_inversions_per_s=1e5, n=4, preset="high",
                        measured_rates=rates)
    want = 1.0 / sum(cnt / rates[prim] for prim, cnt in hist.items())
    assert r["roofline_inversions_per_s_measured_rates"] == round(want, 1)
    assert r["rate_source"] == "measured" and r["int_issue_rate"] is None
    assert r["mfu_pct_vs_measured_roofline"] == round(100.0 * 1e5 / want, 2)
    # a primitive without a rate costs its nominal instructions over "default"
    partial = {"mul": 2e11, "sadd": 8e11, "divide": 1e11, "default": 2e13}
    r = kernel_roofline(n=4, preset="high", measured_rates=partial)
    nominal = roofline._PRIM_NOMINAL_INSTR
    want = 1.0 / (50 / 2e11 + 78 / 8e11 + 22 / 1e11 + sum(
        cnt * nominal[prim] / 2e13 for prim, cnt in hist.items() if prim not in partial))
    assert r["roofline_inversions_per_s_measured_rates"] == round(want, 1)
    assert r["int_issue_rate"] == 2e13 and "mfu_pct_vs_measured_roofline" not in r
    with pytest.raises(ValueError, match="no measured rate"):
        kernel_roofline(n=4, preset="high", measured_rates={"mul": 2e11})


@pytest.mark.parametrize("track,prim", [(False, "mul"), (True, "mul_window_t")])
def test_shared_multiply_operands_are_charged_once(track, prim):
    """HIGH n=4 multiplies 50 times with 9 distinct first and 26 distinct
    second operands; the part of a multiply that depends on one operand is
    counted per distinct operand, and a roofline over a default rate alone
    is that count over the rate."""
    r = kernel_roofline(n=4, preset="high", track=track)
    assert r["distinct_mul_operands"] == [9, 26]
    hist = r["kernel_op_histogram"]
    first, second = roofline._MUL_OPERAND_INSTR[prim]
    unshared = sum(cnt * roofline._PRIM_NOMINAL_INSTR[p] for p, cnt in hist.items())
    want = unshared - (50 - 9) * first - (50 - 26) * second
    assert r["nominal_instructions_per_inversion"] == want < unshared
    assert first + second < roofline._PRIM_NOMINAL_INSTR[prim]
    bound = kernel_roofline(n=4, preset="high", measured_rates={"default": 2e13}, track=track)
    assert bound["roofline_inversions_per_s_measured_rates"] == round(2e13 / want, 1)
    em = emit.emit_circuit(4, 40, 20, 2, True, track)
    assert [len(names) for names in em.mul_operands] == [9, 26]


def test_tracked_roofline_uses_the_tracked_histogram():
    rates = {"default": 1e13}
    plain = kernel_roofline(n=4, preset="high", measured_rates=rates)
    tracked = kernel_roofline(n=4, preset="high", measured_rates=rates, track=True)
    assert "mul_window_t" in tracked["kernel_op_histogram"]
    assert (tracked["roofline_inversions_per_s_measured_rates"]
            < plain["roofline_inversions_per_s_measured_rates"])


def test_rooflines_caps_at_100_and_reports_the_overcount():
    """The share is not capped: up to 105% of the bound it is reported as
    measured, past it the table raises (a rate that beats the least work
    known for the function means the count or a rate is wrong)."""
    rates = {"default": 1e13}
    bound = {n: kernel_roofline(n=n, preset="high", measured_rates=rates)[
        "roofline_inversions_per_s_measured_rates"] for n in (2, 3, 4)}
    table = rooflines([2, 3, 4], "high", rates,
                      measured={2: bound[2] / 2, 3: bound[3] * 1.04})
    assert list(table) == ["n=2", "n=3", "n=4"]
    assert table["n=2"]["mfu_pct_dispatched"] == 50.0
    assert table["n=3"]["mfu_pct_dispatched"] == 104.0
    assert not any("issue_bound" in k or "overcount" in k for row in table.values() for k in row)
    assert "mfu_pct_dispatched" not in table["n=4"]
    with pytest.raises(ValueError, match="n=3"):
        rooflines([2, 3], "high", rates, measured={3: bound[3] * 1.5})
    for row in table.values():
        assert "kernel_op_histogram" not in row
        assert "mfu_pct_vs_measured_roofline" not in row
    assert rooflines([4], "high")["n=4"]["rate_source"] == "none"


def test_no_tpu_rate_in_the_module():
    assert not hasattr(roofline, "MEASURED_U32_RATE_V5E")
    assert not hasattr(roofline, "_ALU_PRIMS")


STATS_CASES = [("high", 2), ("high", 3), ("high", 4), ("high", 5), ("low", 3), ("low", 7)]


@pytest.mark.parametrize("preset,n", STATS_CASES, ids=[f"{p}_n{n}" for p, n in STATS_CASES])
def test_circuit_stats_match_jax(preset, n):
    """Additions, multiplications and divisions of the packed ``unroll``
    circuit equal the JAX package's, also where JAX groups a dot product
    (LOW n=7) and the port runs it op by op.  From n = 6 the JAX circuit by
    default folds the n output rows of the substitution into a tensor axis
    (``vectorize_rows``), which traces, and so counts, each of their ops
    once; the port has no such axis, so JAX is asked for the row-by-row
    circuit, whose results are the same bits."""
    p = mt.PRESETS[preset].replace(n=n)
    args = dict(n=n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
                qfloat_base=p.qfloat_base, true_division=p.true_division, lowering="unroll")
    want = jax_circuit_stats(
        functools.partial(jax_inverse_packed_io, vectorize_rows=False, **args),
        jnp.zeros((2, n * n), jnp.int64), jnp.ones((2, n * n), jnp.int64),
    )
    got = circuit_stats(
        functools.partial(mt.qfloat_matrix_inverse_packed_io, **args),
        torch.zeros((2, n * n), dtype=torch.int64), torch.ones((2, n * n), dtype=torch.int64),
    )
    assert got == want and got["multiplications"] > 0
    assert set(got) == {"additions", "multiplications", "divisions"}
    # the emitted kernel body counts the same ops
    QFloatBase.reset_stats()
    em = emit.emit_circuit(n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    assert (QFloatBase.ADDITIONS, QFloatBase.MULTIPLICATION, QFloatBase.DIVISION) == (
        want["additions"], want["multiplications"], want["divisions"])
    assert em.ops["sadd"] == want["additions"] and em.ops["mul"] == want["multiplications"]
    assert em.ops.get("divide", 0) + em.ops.get("invert", 0) == want["divisions"]


def test_show_and_reset_stats(capsys):
    QFloatBase.reset_stats()
    a = mt.PackedQFloat(torch.tensor([3 << 20]), 40, 20, 2)
    b = mt.PackedQFloat(torch.tensor([5 << 20]), 40, 20, 2)
    c = a + b
    c *= a
    c = c / b
    c.invert()
    c += mt.Zero()                        # adding Zero counts nothing
    c *= mt.SignedBinary(-1)              # a sign flip is no multiplication
    c += mt.SignedBinary(1)               # adding a SignedBinary is an addition
    assert (QFloatBase.ADDITIONS, QFloatBase.MULTIPLICATION, QFloatBase.DIVISION) == (2, 1, 2)
    QFloatBase.show_stats()
    out = capsys.readouterr().out
    assert "Additions       : 2" in out and "Divisions       : 2" in out
    QFloatBase.reset_stats()
    assert QFloatBase.ADDITIONS == QFloatBase.MULTIPLICATION == QFloatBase.DIVISION == 0
    assert mi.core.qfloat.QFloatBase is not QFloatBase
