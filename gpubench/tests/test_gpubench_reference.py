"""The frozen reference, bit for bit with the program's CPU path (its plain
arithmetic) at tiny sizes: n = 2, 4 and 10, every I/O form, on matrices
that include the singular, the all-zero and ties of the pivot."""

import numpy as np
import pytest
import torch

from gpubench import reference
from gpubench.reference import circuit, marshal
from matrix_inversion_tpu_torch.config import HIGH, LOW, MEDIUM_PLUS
from matrix_inversion_tpu_torch.runtime.api import BatchedMatrixInversion

PRESETS = {"high": HIGH, "low": LOW, "medium+": MEDIUM_PLUS}


def _matrices(n, batch=29, seed=0):
    m = np.random.default_rng(seed + n).standard_normal((batch, n, n)) * 100
    m[0] = 0.0  # all zero
    m[1, :, 0] = 0.0  # a zero column: singular
    m[2] = m[3]
    m[4, 1] = m[4, 0]  # two equal rows
    m[5] = np.round(m[5])  # integers: ties of magnitude
    m[6] = np.eye(n) * 1e6  # past the integer part's 20 digits
    m[7] = -m[7] * 1e-7  # small values, fraction digits only
    return m


def _fmt(p, n):
    return {"n": n, "qfloat_len": p.qfloat_len, "qfloat_ints": p.qfloat_ints,
            "qfloat_base": p.qfloat_base, "true_division": p.true_division}


@pytest.mark.parametrize("preset,n", [("high", 2), ("high", 4), ("high", 10), ("low", 4),
                                      ("medium+", 3)])
@pytest.mark.parametrize("io", ["packed", "digits"])
def test_reference_equals_the_program_bit_for_bit(preset, n, io):
    p = PRESETS[preset].replace(n=n)
    m = _matrices(n)
    inv = BatchedMatrixInversion(p, m.shape[0], backend="packed", io=io, device="cpu")
    got = inv.run_raw(*inv.quantize(m))
    want = reference.expected(torch.from_numpy(m), _fmt(p, n), io, block=10)
    if io == "packed":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_reference_floats_equal_the_program_floats(n):
    p = HIGH.replace(n=n)
    m = _matrices(n)
    inv = BatchedMatrixInversion(p, m.shape[0], backend="packed", io="packed", device="cpu")
    want = reference.expected(torch.from_numpy(m), _fmt(p, n), "floats").numpy()
    got = inv.run(m)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_quantize_and_digits_equal_the_program():
    p = HIGH.replace(n=4)
    m = _matrices(4)
    mags, signs = marshal.quantize(torch.from_numpy(m), 40, 20, 1)
    inv = BatchedMatrixInversion(p, m.shape[0], backend="packed", io="packed", device="cpu")
    got_m, got_s = inv.quantize(m)
    assert torch.equal(mags, got_m) and torch.equal(signs, got_s)
    digits = marshal.to_digits(mags, 40, 1)
    inv_d = BatchedMatrixInversion(p, m.shape[0], backend="packed", io="digits", device="cpu")
    got_d, _ = inv_d.quantize(m)
    assert torch.equal(digits, got_d)
    assert torch.equal(marshal.from_digits(digits, 1), mags)


def test_widen_writes_a_narrower_result_exactly():
    mags = torch.tensor([[0, 1, 2**30 + 7, 5]], dtype=torch.int64)
    wide = marshal.widen(mags, (31, 16), (40, 20), 1)
    signs = torch.ones_like(mags)
    assert torch.equal(marshal.dequantize(wide, signs, 40, 20, 1, 2),
                       marshal.dequantize(mags, signs, 31, 16, 1, 2))
    with pytest.raises(ValueError):
        marshal.widen(mags, (40, 20), (31, 16), 1)


def test_the_control_differs_from_the_configuration():
    m = torch.from_numpy(_matrices(4))
    high = _fmt(HIGH, 4)
    low = _fmt(MEDIUM_PLUS, 4)
    got = reference.expected(m, low, "packed", cells_fmt=high)
    want = reference.expected(m, high, "packed")
    assert (got[0] != want[0]).float().mean() > 0.5


def test_the_reference_takes_power_of_two_bases_only():
    with pytest.raises(ValueError):
        reference.bits_of(10)
    assert circuit.floor_div(torch.tensor([7]), torch.tensor([0]), 5).item() == 31
