"""Port vs JAX package: PackedQFloat on int64 torch tensors.

Modelled on tests/test_pair_qfloat.py: the same random digits become a
JAX ``PackedQFloat`` and the port's, every operation runs on both, and
magnitudes and signs must be equal.
"""

import numpy as np
import pytest
import torch

from matrix_inversion_tpu.core.qfloat import SignedBinary as JSB
from matrix_inversion_tpu.core.qfloat import Zero as JZero
from matrix_inversion_tpu.ops.packed import PackedQFloat as JPacked

from matrix_inversion_tpu_torch.core.qfloat import SignedBinary, Zero
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat, packed_long_division

torch.set_num_threads(2)

# widest length per base that the packed encodings allow (division
# dividends of len + frac digits stay < 2**62)
_LEN_INTS = {2: (23, 9), 4: (14, 5), 16: (9, 4)}


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def rand_qf(rng, B=64, length=None, ints=None, base=2, allow_zero_sign=False):
    """The same random QFloat as (JAX PackedQFloat, port PackedQFloat)."""
    if length is None:
        length, ints = _LEN_INTS[base]
    digits = rng.randint(0, base, size=(B, length))
    signs = rng.choice([-1, 0, 1] if allow_zero_sign else [-1, 1], size=B)
    jp = JPacked.from_digits(digits, ints, base, signs)
    tp = PackedQFloat(
        torch.tensor(np.asarray(jp.mag)), length, ints, base,
        torch.from_numpy(signs.astype(np.int64)),
    )
    return jp, tp


def sb_pair(values):
    """SignedBinary with the same dynamic values for both packages."""
    values = np.asarray(values)
    return JSB(values), SignedBinary(torch.from_numpy(values.astype(np.int64)))


def assert_same(jp, tp):
    if isinstance(jp, JZero):
        assert isinstance(tp, Zero)
        return
    assert (len(jp), jp.ints, jp.base) == (len(tp), tp.ints, tp.base)
    np.testing.assert_array_equal(np.asarray(jp.mag), tp.mag.numpy())
    shape = tuple(tp.bshape)
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(jp.sign), shape),
        np.broadcast_to(np.asarray(tp.sign), shape),
    )


@pytest.mark.parametrize("base", [2, 4, 16])
def test_add_sub(rng, base):
    j1, t1 = rand_qf(rng, base=base)
    j2, t2 = rand_qf(rng, base=base, allow_zero_sign=True)
    assert_same(j1 + j2, t1 + t2)
    assert_same(j1 - j2, t1 - t2)
    assert_same(j2 - j1, t2 - t1)
    for v in (-1, 0, 1):
        assert_same(j1 + JSB(v), t1 + SignedBinary(v))
        assert_same(JSB(v) - j2, SignedBinary(v) - t2)
    jsb, tsb = sb_pair(rng.choice([-1, 0, 1], size=64))
    assert_same(j1 + jsb, t1 + tsb)
    assert_same(j2 + jsb, t2 + tsb)
    assert_same(j1 + JZero(), t1 + Zero())


@pytest.mark.parametrize("base", [2, 4, 16])
def test_compare(rng, base):
    j1, t1 = rand_qf(rng, base=base, allow_zero_sign=True)
    j2, t2 = rand_qf(rng, base=base, allow_zero_sign=True)
    for jx, tx in ((j1, t1), (j2, t2)):
        for jy, ty in ((j1, t1), (j2, t2)):
            np.testing.assert_array_equal(np.asarray(jx > jy), (tx > ty).numpy())
            np.testing.assert_array_equal(np.asarray(jx == jy), (tx == ty).numpy())
            np.testing.assert_array_equal(np.asarray(jx >= jy), (tx >= ty).numpy())
            np.testing.assert_array_equal(np.asarray(jx < jy), (tx < ty).numpy())
            np.testing.assert_array_equal(np.asarray(jx <= jy), (tx <= ty).numpy())
    # equal magnitudes with different signs take the sign branch
    j3, t3 = abs(j1), abs(t1)
    np.testing.assert_array_equal(np.asarray(j3 > -j3), (t3 > -t3).numpy())


@pytest.mark.parametrize("base", [2, 4, 16])
def test_mul(rng, base):
    j1, t1 = rand_qf(rng, base=base)
    j2, t2 = rand_qf(rng, base=base, allow_zero_sign=True)
    assert_same(j1 * j2, t1 * t2)
    assert_same(JPacked.from_mul(j1, j2), PackedQFloat.from_mul(t1, t2))
    for v in (-1, 0, 1):
        assert_same(j1 * JSB(v), t1 * SignedBinary(v))
    jsb, tsb = sb_pair(rng.choice([-1, 0, 1], size=64))
    assert_same(jsb * j1, tsb * t1)
    assert_same(
        JPacked.from_mul(jsb, j1, 30, 5), PackedQFloat.from_mul(tsb, t1, 30, 5)
    )
    assert isinstance(PackedQFloat.from_mul(t1, Zero()), Zero)


@pytest.mark.parametrize("base", [2, 4, 16])
def test_from_mul_formats(rng, base):
    """Random (a_len, a_ints) x (b_len, b_ints) -> (newlength, newints),
    including all-fraction operands and widening outputs (t1 <= 0)."""
    maxlen = {2: 40, 4: 20, 16: 10}[base]
    for _ in range(40):
        a_len, b_len = rng.randint(2, maxlen + 1, size=2)
        a_ints, b_ints = rng.randint(0, a_len + 1), rng.randint(0, b_len + 1)
        newlength = rng.randint(2, maxlen + 1)
        newints = rng.randint(0, newlength + 1)
        j1, t1 = rand_qf(rng, 16, a_len, a_ints, base)
        j2, t2 = rand_qf(rng, 16, b_len, b_ints, base)
        assert_same(
            JPacked.from_mul(j1, j2, newlength, newints),
            PackedQFloat.from_mul(t1, t2, newlength, newints),
        )


def test_from_mul_circuit_formats(rng):
    """The formats the circuits use: the reference's crop corner
    (18,18)x(25,0)->(18,1), the 2x2 widened (2*ints+3, 2*ints) product,
    the reciprocal multiply (len,ints)x(len,0)->(len,ints) and the 2x2
    adjugate times (len,0) determinant inverse."""
    cases = [
        ((18, 18), (25, 0), (18, 1)),
        ((40, 20), (40, 20), (43, 40)),
        ((23, 9), (23, 0), (23, 9)),
        ((31, 16), (31, 0), (31, 16)),
        ((40, 20), (40, 0), (40, 20)),
        ((23, 9), (23, 9), (21, 18)),
    ]
    for (al, ai), (bl, bi), (nl, ni) in cases:
        j1, t1 = rand_qf(rng, 64, al, ai)
        j2, t2 = rand_qf(rng, 64, bl, bi)
        assert_same(JPacked.from_mul(j1, j2, nl, ni), PackedQFloat.from_mul(t1, t2, nl, ni))


@pytest.mark.parametrize("base", [2, 4])
def test_division(rng, base):
    length, ints = _LEN_INTS[base]
    j1, t1 = rand_qf(rng, base=base)
    j2, t2 = rand_qf(rng, base=base, allow_zero_sign=True)
    assert_same(j1 / j2, t1 / t2)
    # division by an encrypted zero saturates
    z = np.zeros((64, length), dtype=np.int64)
    jz = JPacked.from_digits(z, ints, base, np.ones(64, np.int64))
    tz = PackedQFloat(torch.zeros(64, dtype=torch.int64), length, ints, base,
                      torch.ones(64, dtype=torch.int64))
    assert_same(j1 / jz, t1 / tz)
    # division by SignedBinary: +-1 sets the sign, 0 saturates
    for v in (1, -1, 0):
        assert_same(j1 / JSB(v), t1 / SignedBinary(v))
    jsb, tsb = sb_pair(rng.choice([-1, 0, 1], size=64))
    assert_same(j1 / jsb, t1 / tsb)
    with pytest.raises(ValueError):
        t1 / Zero()


@pytest.mark.parametrize("base", [2, 4])
def test_invert(rng, base):
    length, ints = _LEN_INTS[base]
    j1, t1 = rand_qf(rng, base=base, allow_zero_sign=True)
    assert_same(j1.invert(1, length, 0), t1.invert(1, length, 0))
    assert_same(j1.invert(-1, length - 2, ints - 2), t1.invert(-1, length - 2, ints - 2))
    jsb, tsb = sb_pair(rng.choice([-1, 1], size=64))
    assert_same(j1.invert(jsb, length, 0), t1.invert(tsb, length, 0))
    # SignedBinary / QFloat is a signed reciprocal
    assert_same(JSB(-1) / j1, SignedBinary(-1) / t1)
    # zero divisors saturate
    jz, tz = rand_qf(rng, base=base)
    jz = JPacked(jz.mag * 0, length, ints, base, 1)
    tz = PackedQFloat(tz.mag * 0, length, ints, base, 1)
    assert_same(jz.invert(1, length, 0), tz.invert(1, length, 0))


def test_high_precision_true_division(rng):
    """High preset widths: len=40, ints=20 (a 60-digit dividend)."""
    j1, t1 = rand_qf(rng, length=40, ints=20)
    j2, t2 = rand_qf(rng, length=40, ints=20)
    assert_same(j1 / j2, t1 / t2)
    assert_same(j1.invert(1, 40, 0), t1.invert(1, 40, 0))
    j3, t3 = rand_qf(rng, length=43, ints=40)
    assert_same(j3.invert(1, 40, 0), t3.invert(1, 40, 0))


def test_long_division_exact():
    """Exact floor division on floor boundaries (v = q*d, q*d - 1,
    q*d + d - 1) at the High widths, and zero-divisor saturation."""
    n_bits, divisor_bits = 60, 40
    vmax = (1 << n_bits) - 1
    vs, ds = [], []
    pyrng = np.random.RandomState(7)
    for _ in range(2048):
        d = int(pyrng.randint(1, 1 << 31)) * int(pyrng.randint(1, 1 << 9)) + 1
        d = min(d, (1 << divisor_bits) - 1)
        q = int(pyrng.randint(0, 1 << 20))
        for v in (q * d, q * d - 1, q * d + d - 1):
            if 0 <= v <= vmax:
                vs.append(v)
                ds.append(d)
    vs += [vmax, vmax, 0, 1, vmax]
    ds += [1, (1 << divisor_bits) - 1, 5, 1, 0]
    expected = [v // d if d else vmax for v, d in zip(vs, ds)]
    for divisor_bits_arg in (divisor_bits, None):  # K2's route, K3's route
        got = packed_long_division(torch.tensor(vs), torch.tensor(ds), n_bits, 1,
                                   divisor_bits=divisor_bits_arg)
        assert got.tolist() == expected


def test_set_len_ints(rng):
    for newlen, newints in [(30, 9), (18, 5), (23, 12), (23, 3), (40, 20), (20, 9)]:
        j, t = rand_qf(rng)
        assert_same(j.copy().set_len_ints(newlen, newints), t.copy().set_len_ints(newlen, newints))


def test_blend_abs_neg(rng):
    j1, t1 = rand_qf(rng, allow_zero_sign=True)
    j2, t2 = rand_qf(rng)
    cond = rng.randint(0, 2, size=64)
    assert_same(
        j1.copy().blend_from(j2, cond),
        t1.copy().blend_from(t2, torch.from_numpy(cond)),
    )
    assert_same(abs(j1), abs(t1))
    assert_same(-j1, -t1)
    assert_same(j1.copy().neg(), t1.copy().neg())
