"""Roofline analysis for the batched inversion programs.

Port of ``matrix_inversion_tpu/utils/roofline.py``.  The headline
inversions/s number needs a denominator.  This module counts the *logical
elementwise work* of a circuit, and compares the achieved rate against the
card's integer issue rate.  Two counts:

* :func:`count_u32_ops` / :func:`flagship_roofline`: the eager op-by-op
  circuit, as 32-bit-equivalent ALU ops per inversion.  The JAX module
  walks a jaxpr; here a ``TorchDispatchMode`` sees every aten op the
  function dispatches.  The cost model is the same:

  - every elementwise arithmetic/logic/compare/select op costs
    ``#output elements x dtype_weight`` 32-bit-equivalent ops;
  - int64 ops weigh 2 in the floor reading and a per-op weight in the
    realistic one.  The weights were reckoned for a machine without 64-bit
    integer ALUs, and this card has none either: an int64 add is two
    32-bit instructions joined by the carry, a 64-bit multiply several
    ``IMAD``s, a 64-bit shift a funnel-shift pair, so the table's meaning
    carries over.  The weights are reckoned, not measured;
  - data movement (view, reshape, expand, slice, cat, copy, a conversion
    between dtypes, a fill) costs 0: this is an ALU roofline.

* :func:`kernel_op_histogram` / :func:`kernel_roofline`: the fused kernel
  K1's ACTUAL body, which is not that op list but calls to the cell
  primitives of ``csrc/qfloat_cell.cuh``.  The histogram is the tally the
  emitter keeps while it records the body (``ops/emit.py``), and the bound
  divides each primitive's count by a measured rate on the card
  (``utils/ubench.py``).  Over ``u32_kernelmix``'s rate alone, each
  primitive at the fewest instructions known for its function, that is
  the kernel's bound; over the rates of the port's own primitives
  (``cell_mul``, ``cell_sadd``, ``cell_mul_window_t``, ``cell_divide``) it
  is the time the body as written takes if nothing is shared.  There is
  no built-in measured rate: without ``measured_rates`` the function
  returns counts and no bound.

:data:`PUBLISHED_INT32_RATE_H100` is the card's published peak for 32-bit
integer instructions, 132 SMs x 64 INT32 lanes x 1.98 GHz, and
:data:`PUBLISHED_ISSUE_RATE_H100` its issue limit over all pipes; they are
a data sheet's numbers, used where a share of a peak is stated and as the
default of :func:`flagship_roofline`, never as measurements.

    python -m matrix_inversion_tpu_torch.utils.roofline [inversions/s] [kernel]
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: published peak of one H100 SXM for 32-bit integer instructions per second
PUBLISHED_INT32_RATE_H100 = 132 * 64 * 1.98e9

#: the most thread-instructions per second one H100 SXM can issue: 132 SMs x
#: 4 warp schedulers x 32 threads x 1.98 GHz.  Integer work spread over the
#: INT32 pipe and the FMA pipe (``IMAD``) can pass the INT32 peak, never this.
PUBLISHED_ISSUE_RATE_H100 = 132 * 4 * 32 * 1.98e9

# aten op (in-place underscore stripped) -> the JAX primitive it is costed as
_ATEN_ALU_OPS = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul",
    "div": "div", "floor_divide": "div", "true_divide": "div",
    "remainder": "rem", "fmod": "rem",
    "neg": "neg", "sign": "sign", "sgn": "sign", "abs": "abs",
    "maximum": "max", "minimum": "min",
    "bitwise_and": "and", "__and__": "and", "__iand__": "and", "logical_and": "and",
    "bitwise_or": "or", "__or__": "or", "__ior__": "or", "logical_or": "or",
    "bitwise_xor": "xor", "__xor__": "xor", "__ixor__": "xor", "logical_xor": "xor",
    "bitwise_not": "not", "logical_not": "not",
    "bitwise_left_shift": "shift_left", "__lshift__": "shift_left",
    "__ilshift__": "shift_left",
    "bitwise_right_shift": "shift_right_arithmetic",
    "__rshift__": "shift_right_arithmetic", "__irshift__": "shift_right_arithmetic",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
    "where": "select_n",
    "clamp": "clamp", "clamp_min": "clamp", "clamp_max": "clamp",
    "floor": "floor", "ceil": "ceil", "round": "round", "pow": "pow",
}

# dtype -> 32-bit-equivalent weight per element (optimistic floor: int64 = 2)
_DTYPE_WEIGHT = {
    torch.int64: 2.0, torch.uint64: 2.0,
    torch.int32: 1.0, torch.uint32: 1.0, torch.float32: 1.0,
    torch.int16: 1.0, torch.uint16: 1.0, torch.bfloat16: 1.0,
    torch.int8: 1.0, torch.uint8: 1.0, torch.bool: 1.0,
    torch.float64: 2.0,
}

# realistic per-op cost of 64-bit work in 32-bit instructions (carry-chain
# add/sub 3, wide multiply ~6, funnel shifts ~4, lexicographic compares ~3,
# pure bitwise 2)
_S64_PRIM_WEIGHT = {
    "add": 3.0, "sub": 3.0, "neg": 3.0, "abs": 3.0, "sign": 3.0,
    "mul": 6.0, "div": 12.0, "rem": 12.0,
    "max": 4.0, "min": 4.0,
    "shift_left": 4.0, "shift_right_logical": 4.0,
    "shift_right_arithmetic": 4.0,
    "lt": 3.0, "le": 3.0, "gt": 3.0, "ge": 3.0,
    "eq": 2.5, "ne": 2.5,
    "and": 2.0, "or": 2.0, "xor": 2.0, "not": 2.0,
    "select_n": 2.0, "clamp": 4.0, "integer_pow": 6.0,
}

# Nominal 32-bit instructions of one call of each primitive of
# csrc/qfloat_cell.cuh at the High format (base 2, 40 digits, 20 integer): the
# fewest that an exact implementation of the primitive's FUNCTION is known to
# need on a machine of 32-bit ALUs, reckoned from the operand widths and the
# row counts.  They are not what this port's code compiles to (that is the
# issued-instructions figure, counted in SASS by
# utils/ubench.py::sass_loop_instructions and printed beside the bound), and
# none is a time.  They cost a primitive that has no measured rate (over the
# "default" rate) and give the kernel's count of operations for its bound.
_PRIM_NOMINAL_INSTR = {
    # two 64-bit words negated or zeroed under their signs, the add with its
    # carry, |v|, the mask on the high word, the zero test and the sign select
    "sadd": 23.0,
    # sadd and a compare of |v| with the mask
    "sadd_t": 25.0,
    # out = ((a*b - aL*bL) >> 20) + sum over the 20 digits p of aL of
    # a_p * (bL >> (20 - p)), aL and bL the operands' low 20 bits, all below
    # the crop in 32-bit words: the low 64 bits of a*b 3 and aL*bL 1 multiply
    # instructions, subtract 2, shift 2, 20 selects and 10 three-input adds
    # 30, add and mask 3 (41); the 20 digit masks of a 20 and the 20 shifted
    # copies of bL 20 depend on one operand each (_MUL_OPERAND_INSTR)
    "mul": 81.0,
    # 40 rows, each the cropped window of b selected by a digit of a (2) and
    # added into a 64-bit accumulator that must wrap (2), flag and mask 3
    # (163); the 40 digit masks 40 and the 40 windows of b, a 64-bit shift
    # each, 80 depend on one operand each
    "mul_window_t": 283.0,
    # the card's own 64-bit division routine, 69 instructions with no shorter
    # path, which the library's integer division runs too, and the shift of
    # the dividend, the zero test and the mask
    "divide": 80.0,
    # divide without the dividend's shift
    "invert": 78.0,
    # a shift and a test of the digits above the window
    "divide_t": 83.0,
    "invert_t": 81.0,
    # 64-bit signed compare 2, magnitude inequality 2, sign compares 2, xor and select 2
    "gt": 8.0,
    # a test and a 32-bit select per half
    "blend": 3.0,
    # a mask 2 and a 64-bit shift 2
    "set_len_ints": 4.0,
    # a test and a select per half
    "sb_div_mag": 3.0,
    # a test and a select
    "sb_div_sign": 2.0,
    # one add, multiply or compare on 32-bit ints
    "int": 1.0,
    # one or
    "flag_or": 1.0,
}

# Of a multiply's nominal instructions, those that depend on its first operand
# only and on its second only.  A body computes them once for every multiply
# that shares the operand (a row of an LU update multiplies one cell by many),
# so its count of operations charges them per distinct operand.
_MUL_OPERAND_INSTR = {"mul": (20.0, 20.0), "mul_window_t": (40.0, 80.0)}


def _nominal_instructions(hist, first_operands, second_operands):
    """{primitive: nominal instructions per inversion} of a histogram whose
    multiplies have that many distinct first and second operands."""
    out = {prim: cnt * _PRIM_NOMINAL_INSTR[prim] for prim, cnt in hist.items()}
    for prim, (first, second) in _MUL_OPERAND_INSTR.items():
        if prim in hist:
            out[prim] -= ((hist[prim] - first_operands) * first
                          + (hist[prim] - second_operands) * second)
    return out


class _OpCounter(TorchDispatchMode):
    """Adds up the cost of every elementwise ALU op dispatched under it."""

    def __init__(self, realistic):
        super().__init__()
        self.realistic = realistic
        self.total = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.endswith("__"):
            name = name[:-1]
        prim = _ATEN_ALU_OPS.get(name)
        if prim is not None:
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                if self.realistic and t.dtype in (torch.int64, torch.uint64, torch.float64):
                    w = _S64_PRIM_WEIGHT.get(prim, 2.0)
                else:
                    w = _DTYPE_WEIGHT.get(t.dtype, 1.0)
                self.total += float(t.numel()) * w
        # everything else (views, copies, fills, conversions, reductions) is
        # data movement or not elementwise: 0 ALU cost
        return out


def count_u32_ops(fn, *example_args, realistic: bool = False) -> float:
    """Total 32-bit-equivalent elementwise ops of one call of ``fn``, which
    is run once on ``example_args`` (give it small CPU tensors).

    ``realistic=False`` uses the optimistic int64 = 2 floor (max-headroom
    reading); ``realistic=True`` uses the per-op table.  A Python loop
    counts every pass it makes.
    """
    with _OpCounter(realistic) as counter:
        fn(*example_args)
    return counter.total


def flagship_roofline(
    batch: int = None,
    measured_inversions_per_s: float = None,
    int_ops_per_s: float = PUBLISHED_INT32_RATE_H100,
):
    """Ops/inversion + roofline for the flagship n=4 High packed circuit,
    run op by op on CPU tensors.

    Returns a dict with ops_per_inversion, the issue-bound inversions/s,
    and (when a measured rate is given) the achieved share.  The default
    bound is the card's published 32-bit integer peak; pass a measured
    issue rate (``utils/ubench.py``) for a measured roofline.
    """
    from ..config import PRESETS
    from ..models.inverse import qfloat_matrix_inverse_packed_io

    p = PRESETS["high"].replace(n=4)
    B = batch or 1024
    fn = functools.partial(
        qfloat_matrix_inverse_packed_io,
        n=p.n,
        qfloat_len=p.qfloat_len,
        qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base,
        true_division=p.true_division,
        lowering="unroll",
    )
    mags = torch.zeros((B, 16), dtype=torch.int64)
    signs = torch.ones((B, 16), dtype=torch.int64)
    per_inv = count_u32_ops(fn, mags, signs) / B
    per_inv_real = count_u32_ops(fn, mags, signs, realistic=True) / B
    bound = int_ops_per_s / per_inv
    bound_real = int_ops_per_s / per_inv_real
    out = {
        "ops_per_inversion_u32eq_floor": round(per_inv, 1),
        "ops_per_inversion_u32eq_realistic": round(per_inv_real, 1),
        "int_ops_per_s": int_ops_per_s,
        "roofline_inversions_per_s_upper": round(bound, 1),
        "roofline_inversions_per_s_realistic": round(bound_real, 1),
    }
    if measured_inversions_per_s:
        out["measured_inversions_per_s"] = measured_inversions_per_s
        out["mfu_pct_vs_upper"] = round(
            100.0 * measured_inversions_per_s / bound, 2
        )
        out["mfu_pct_vs_realistic"] = round(
            100.0 * measured_inversions_per_s / bound_real, 2
        )
    return out


def kernel_op_histogram(n: int = 4, preset: str = "high", track: bool = False):
    """Primitive histogram of the ACTUAL fused-kernel body, per inversion.

    The count above models the eager int64 ops; the fused kernel executes a
    different program, the statements ``ops/emit.py`` records from the
    circuit.  This runs the emitter and returns its tally by primitive of
    ``csrc/qfloat_cell.cuh`` (``"int"``: a statement of sign or pivot
    arithmetic; ``"flag_or"``: an ``ovf |= flag`` of the tracked body),
    largest first: the true instruction mix (what to optimize next) and the
    numerator of a measured-rate roofline (see :func:`kernel_roofline`).
    """
    return dict(_emitted(n, preset, track)[0])


@functools.lru_cache(maxsize=None)
def _emitted(n, preset, track):
    """``(histogram, distinct first operands, distinct second operands of
    the multiplies)`` of the emitted body, emitted once per argument set
    (seconds at n = 12)."""
    from ..config import PRESETS
    from ..ops.emit import emit_circuit

    p = PRESETS[preset].replace(n=n)
    em = emit_circuit(p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
                      p.true_division, track)
    hist = dict(sorted(em.ops.items(), key=lambda kv: -kv[1]))
    return hist, len(em.mul_operands[0]), len(em.mul_operands[1])


def function_savings(n, true_division, track=False):
    """``{primitive: count}`` that the emitted straight-line body makes and
    the inversion's function does not need, per inversion, as the lanes
    design (``csrc/fused_inverse_lanes.cu``) shows: P.M's one-hot chains
    make n - 1 signed adds a cell where the selected cell and one add give
    the same bits (n*n*(n-2) fewer), and the reciprocals of U's diagonal
    are computed twice (n fewer, without true division); tracked, each of
    them ORs a flag.  None at n = 2, the closed form."""
    if n < 3:
        return {}
    out = {"sadd_t" if track else "sadd": n * n * (n - 2)}
    if not true_division:
        out["invert_t" if track else "invert"] = n
    if track:
        out["flag_or"] = sum(out.values())
    return out


def function_op_histogram(n: int = 4, preset: str = "high", track: bool = False):
    """The least work known for the inversion's function, by primitive: the
    emitted body's histogram (:func:`kernel_op_histogram`) less
    :func:`function_savings`.  The bound of either design of K1."""
    from ..config import PRESETS

    saved = function_savings(n, PRESETS[preset].true_division, track)
    hist = {k: v - saved.get(k, 0) for k, v in _emitted(n, preset, track)[0].items()}
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def kernel_roofline(measured_inversions_per_s=None, n=4, preset="high",
                    measured_rates=None, track=False, as_emitted=False):
    """Roofline for the fused kernel from the op histogram of its function
    (:func:`function_op_histogram`, the bound of both designs), or with
    ``as_emitted`` from the straight-line body's own (its count is
    ``nominal_instructions_per_inversion_as_emitted`` either way).

    ``measured_rates``: {primitive name: primitives/s on the whole card},
    measured with ``utils/ubench.py``.  A primitive without an entry is
    costed as its nominal 32-bit instructions (``_PRIM_NOMINAL_INSTR``, the
    multiplies' one-operand parts charged per distinct operand) over
    ``measured_rates["default"]``, an instructions/s rate.  With only a
    ``"default"`` the result bounds the function: the fewest instructions
    known for it over a measured issue rate.  With the rates of this port's
    own primitives, each timed alone, it models the body as it is, and the
    body may pass that model where its multiplies share work.  Without
    ``measured_rates`` there is no bound: the function returns the
    histogram and the counts with ``rate_source`` ``"none"``.
    """
    emitted, first_operands, second_operands = _emitted(n, preset, track)
    hist = emitted if as_emitted else function_op_histogram(n, preset, track)
    nominal = _nominal_instructions(hist, first_operands, second_operands)
    out = {
        "ops_per_inversion_kernel": round(float(sum(hist.values())), 1),
        "kernel_op_histogram": {k: round(float(v), 1) for k, v in hist.items()},
        "distinct_mul_operands": [first_operands, second_operands],
        "nominal_instructions_per_inversion": round(sum(nominal.values()), 1),
        "nominal_instructions_per_inversion_as_emitted": round(sum(
            _nominal_instructions(emitted, first_operands, second_operands).values()), 1),
        "rate_source": "measured" if measured_rates else "none",
    }
    if not measured_rates:
        return out
    rates = dict(measured_rates)
    default = rates.pop("default", None)
    time_per_inv = 0.0
    for prim, cnt in hist.items():
        if prim in rates:
            time_per_inv += cnt / rates[prim]
        elif default is not None:
            time_per_inv += nominal[prim] / default
        else:
            raise ValueError(f"no measured rate for {prim!r} and no 'default' rate")
    bound = 1.0 / time_per_inv
    out["int_issue_rate"] = default
    out["roofline_inversions_per_s_measured_rates"] = round(bound, 1)
    if measured_inversions_per_s:
        out["measured_inversions_per_s"] = measured_inversions_per_s
        out["mfu_pct_vs_measured_roofline"] = round(
            100.0 * measured_inversions_per_s / bound, 2
        )
    return out


def rooflines(sizes, preset="high", rates=None, measured=None, track=False):
    """Per-n measured-rate roofline table: ``{"n=2": {...}, ...}``.

    ``rates`` as :func:`kernel_roofline`'s ``measured_rates``; ``measured``
    maps n to the kernel's measured inversions/s, whose share of the bound
    is ``mfu_pct_dispatched``.  The bulky histogram is dropped.  A bound
    counts the least work known for the kernel's function, so a kernel
    cannot beat it: a measured rate over 105% of the bound (the bound's
    time over 105% of the measured one) means the count or a rate is wrong,
    and raises ``ValueError``.  Writes no file.
    """
    measured = measured or {}
    per_n = {}
    for n in sizes:
        rate = measured.get(n)
        roof = kernel_roofline(
            measured_inversions_per_s=rate, n=n, preset=preset,
            measured_rates=rates, track=track,
        )
        roof.pop("kernel_op_histogram", None)
        roof.pop("mfu_pct_vs_measured_roofline", None)
        bound = roof.get("roofline_inversions_per_s_measured_rates")
        if rate and bound:
            share = 100.0 * rate / bound
            if share > 105.0:
                raise ValueError(
                    f"n={n}: {rate:.4e} inversions/s is {share:.1f}% of the bound {bound:.4e}: "
                    "the count of operations is too high or a rate too low")
            roof["mfu_pct_dispatched"] = round(share, 2)
        per_n[f"n={n}"] = roof
    return per_n


if __name__ == "__main__":
    import sys

    measured = float(sys.argv[1]) if len(sys.argv) > 1 else None
    if len(sys.argv) > 2 and sys.argv[2] == "kernel":
        print(json.dumps(kernel_roofline(measured_inversions_per_s=measured)))
    else:
        print(json.dumps(flagship_roofline(measured_inversions_per_s=measured)))
