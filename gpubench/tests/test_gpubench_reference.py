"""The frozen reference, bit for bit with the program's CPU path (its plain
arithmetic) at tiny sizes: n = 2, 4 and 10, every I/O form, on matrices
that include the singular, the all-zero and ties of the pivot; and its
overflow flags, matrix by matrix, with the program's tracked circuit."""

import numpy as np
import pytest
import torch

from gpubench import reference
from gpubench.reference import circuit, marshal
from matrix_inversion_tpu_torch.config import HIGH, LOW, MEDIUM_PLUS
from matrix_inversion_tpu_torch.ops import packed
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


def _scaled(n, seed=0):
    """:func:`_matrices`, the rest of them scaled by 10**-8 to 10**5: small
    ones whose inverse passes the 20 integer digits, large ones whose sums
    and products do, and some that stay in range."""
    m = _matrices(n, seed=seed)
    m[8:] *= 10.0 ** np.random.default_rng(seed + n).uniform(-8, 5, (m.shape[0] - 8, 1, 1))
    return m


#: HIGH n = 3-5 run K1's straight-line tracked body on the card, 6 and 10
#: its lanes tracked body; on the CPU all run the tracked circuit.  LOW (no
#: true division) inverts U's diagonal into 0 integer digits, so at
#: normal(0, 100) a share of its matrices overflow there.
TRACKED = [("high", 3, _scaled), ("high", 4, _scaled), ("high", 5, _scaled),
           ("high", 6, _scaled), ("high", 10, _scaled), ("low", 4, _matrices),
           ("low", 6, _matrices)]


@pytest.mark.parametrize("preset,n,make", TRACKED, ids=lambda v: getattr(v, "__name__", v))
def test_reference_flags_equal_the_programs_tracked_flags(preset, n, make):
    p = PRESETS[preset].replace(n=n)
    m = make(n)
    tracked = BatchedMatrixInversion(p, m.shape[0], backend="packed", io="packed",
                                     device="cpu", track_overflow=True)
    plain = BatchedMatrixInversion(p, m.shape[0], backend="packed", io="packed", device="cpu")
    got = tracked.run_raw(*tracked.quantize(m))
    untracked = plain.run_raw(*plain.quantize(m))
    want = reference.expected(torch.from_numpy(m), _fmt(p, n), "packed", block=10, track=True)
    assert want[2].dtype == torch.int32 and want[2].shape == (m.shape[0],)
    assert torch.equal(got[2], want[2])
    for part in range(2):
        assert torch.equal(want[part], untracked[part]) and torch.equal(got[part], want[part])
    # a reference that never flags, or always does, fails here
    assert 0 < int(want[2].sum()) < m.shape[0]
    if preset == "low":
        assert want[2].float().mean() >= 0.1


def test_untracked_expected_is_the_tracked_one_less_its_flags():
    m = torch.from_numpy(_scaled(4))
    fmt = _fmt(HIGH, 4)
    plain = reference.expected(m, fmt, "packed")
    assert len(plain) == 2
    assert all(torch.equal(a, b) for a, b in zip(plain, reference.expected(m, fmt, "packed",
                                                                            track=True)))
    with pytest.raises(ValueError):
        reference.expected(m, fmt, "digits", track=True)


#: (a_len, a_ints, b_len, b_ints, newlength, newints, bits): the circuit's
#: products at HIGH and LOW, the 2x2 form's widened ones (which cannot
#: carry: 2 * ints integer digits hold the product's integer part), and
#: base 4 and 16 formats whose windowed sums pass 2**64
MUL_FORMATS = [(40, 20, 40, 20, 40, 20, 1), (40, 20, 40, 20, 43, 40, 1),
               (23, 9, 23, 0, 23, 9, 1), (23, 9, 23, 9, 21, 18, 1),
               (30, 15, 30, 15, 30, 15, 2), (15, 15, 15, 15, 15, 15, 4),
               (15, 8, 15, 7, 15, 9, 4)]


@pytest.mark.parametrize("fmt", MUL_FORMATS, ids=str)
def test_the_windowed_multiply_flags_as_the_programs(fmt):
    a_len, a_ints, b_len, b_ints, newlength, newints, bits = fmt
    rng = np.random.default_rng(sum(fmt))

    def mags(length):
        top = rng.integers(0, length * bits + 1, 4000)  # every width up to the format's
        return torch.from_numpy(rng.integers(0, 2**62, 4000) >> (62 - top))
    a, b = mags(a_len), mags(b_len)
    args = (a, a_len, a_ints, b, b_len, b_ints, newlength, newints, bits)
    mag, carry = circuit.mul_window(*args)
    want_mag, want_carry = packed.mul_window_packed(*args)
    assert torch.equal(mag, want_mag) and torch.equal(carry, want_carry)
    assert torch.equal(mag, circuit.mul_trunc(*args))
    can_carry = newints < a_ints + b_ints
    assert (0 < int(carry.sum()) < carry.numel()) if can_carry else not carry.any()


def test_a_windowed_sum_that_wraps_past_2_to_the_64_is_not_flagged():
    # base 16, 15 integer digits: a's two lowest digits 9 and 8 times b's
    # fifteen 15s sum to 17 * 2**60 - 137, which wraps to 2**60 - 137: a
    # carry that the circuit's uint64 sum cannot see
    a = torch.tensor([8 * 16 + 9])
    b = torch.tensor([16**15 - 1])
    args = (a, 15, 15, b, 15, 15, 15, 15, 4)
    mag, carry = circuit.mul_window(*args)
    assert (8 * 16 + 9) * (16**15 - 1) >= 16**15
    assert not carry.item() and torch.equal(carry, packed.mul_window_packed(*args)[1])
    assert mag.item() == ((8 * 16 + 9) * (16**15 - 1)) % 16**15


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
