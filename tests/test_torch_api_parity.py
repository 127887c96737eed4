"""Port vs JAX package: the public API that the circuits do not reach.

``PackedQFloat``'s conversions, factories, normalization no-ops, chains and
grouped forms (``from_float``, ``zero``/``zero_like``, ``one``/``one_like``,
``tidy``/``base_tidy``/``is_base_tidy``, ``encrypted``, ``to_limb``,
``to_str``/``__str__``, ``iadd_chain``, ``multi_from_mul``, ``multi_invert``);
``Zero.to_float``, ``SignedBinary``'s ``value`` setter, ``encrypted`` and
``to_float``, ``QFloat.encrypted`` and the no-op ``check_convert_fhe`` /
``self_check_convert_fhe``; and the JAX package's arguments of
``qfloat_matrix_inverse_packed_io`` / ``_with_overflow`` (``tensorize`` the
eighth, ``vectorize_rows``).  Each is called under its JAX name on the same
inputs in both packages; magnitudes, digits, signs, flags, strings and op
counts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_inversion_tpu.core.qfloat import QFloat as JQFloat
from matrix_inversion_tpu.core.qfloat import QFloatBase as JQFloatBase
from matrix_inversion_tpu.core.qfloat import SignedBinary as JSB
from matrix_inversion_tpu.core.qfloat import Zero as JZero
from matrix_inversion_tpu.models import inverse as jax_inverse
from matrix_inversion_tpu.ops.packed import PackedQFloat as JPacked
from matrix_inversion_tpu.ops.packed import track_overflow as jax_track_overflow

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core.qfloat import QFloat, QFloatBase, SignedBinary, Zero
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat, track_overflow

torch.set_num_threads(2)

# (length, ints, base): High's format, a Low-like one, base 4 and base 16
FORMATS = [(40, 20, 2), (23, 9, 2), (14, 5, 4), (9, 4, 16)]


def floats(seed, B=37, ints=9, base=2):
    """Values inside and past the integer range, +-0 and exact units."""
    rng = np.random.RandomState(seed)
    f = rng.randn(B) * rng.choice([1e-3, 1.0, 100.0, 4.0 * base ** ints], size=B)
    f[:4] = [0.0, -0.0, 1.0, -1.0]
    return f


def assert_same(jp, tp):
    if isinstance(jp, JZero):
        assert isinstance(tp, Zero)
        return
    if isinstance(jp, JSB):
        assert isinstance(tp, SignedBinary)
        np.testing.assert_array_equal(np.asarray(jp.value), np.asarray(tp.value))
        return
    assert (len(jp), jp.ints, jp.base) == (len(tp), tp.ints, tp.base)
    np.testing.assert_array_equal(np.asarray(jp.mag), tp.mag.numpy())
    shape = tuple(tp.bshape)
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(jp.sign), shape),
                                  np.broadcast_to(np.asarray(tp.sign), shape))


def pair(f, length, ints, base):
    return JPacked.from_float(f, length, ints, base), PackedQFloat.from_float(f, length, ints, base)


@pytest.mark.parametrize("length,ints,base", FORMATS)
def test_from_float_matches_jax(length, ints, base):
    f = floats(length, ints=ints, base=base)
    jp, tp = pair(f, length, ints, base)
    # past the integer range the JAX radix route leaves an untidy magnitude
    # of base**len or more, and the port keeps the low digits, as JAX's native
    # route does (ROADMAP, "settled"): at base 2 equal modulo base**len
    mask = (1 << (tp._bits * length)) - 1
    wide = np.asarray(jp.mag) > mask
    assert wide.any()
    if base == 2:
        np.testing.assert_array_equal(np.asarray(jp.mag) & mask, tp.mag.numpy())
    jp = JPacked(np.where(wide, 0, np.asarray(jp.mag)), length, ints, base, jp.sign)
    tp = PackedQFloat(torch.where(torch.from_numpy(wide), 0, tp.mag), length, ints, base, tp.sign)
    assert_same(jp, tp)
    assert tp.mag.dtype == torch.int64 and isinstance(tp.sign, torch.Tensor)
    for x in (f[5], -2.75, 0.0):
        js, ts = pair(x, length, ints, base)
        assert_same(js, ts)
        assert isinstance(ts.sign, int) and ts.bshape == ()
    # the defaults: ints half the length, base 2, as in JAX
    small = f[np.abs(f) < 8]
    assert_same(JPacked.from_float(small, length), PackedQFloat.from_float(small, length))


@pytest.mark.parametrize("length,ints,base", FORMATS)
def test_factories_match_jax(length, ints, base):
    for bshape in ((), (5,), (2, 3)):
        assert_same(JPacked.zero(length, ints, base, bshape), PackedQFloat.zero(length, ints, base, bshape))
        assert_same(JPacked.one(length, ints, base, bshape), PackedQFloat.one(length, ints, base, bshape))
    jp, tp = pair(floats(3, B=6, ints=ints), length, ints, base)
    assert_same(JPacked.zero_like(jp), PackedQFloat.zero_like(tp))
    assert_same(JPacked.one_like(jp), PackedQFloat.one_like(tp))
    assert PackedQFloat.one_like(tp).to_float().tolist() == [1.0] * 6
    assert PackedQFloat.zero_like(tp).device == tp.device


def test_normalization_no_ops_and_encrypted_match_jax():
    jp, tp = pair(floats(4), 23, 9, 2)
    before = tp.mag.clone()
    assert jp.base_tidy() is None and tp.base_tidy() is None
    assert jp.tidy() is None and tp.tidy() is None
    assert torch.equal(tp.mag, before)
    assert jp.is_base_tidy is True and tp.is_base_tidy is True
    assert jp.encrypted is True and tp.encrypted is True


@pytest.mark.parametrize("length,ints,base", FORMATS)
def test_to_limb_and_to_str_match_jax(length, ints, base):
    f = floats(5, B=9, ints=ints)
    jp, tp = pair(f, length, ints, base)
    jl, tl = jp.to_limb(), tp.to_limb()
    assert isinstance(tl, QFloat) and (len(tl), tl.ints, tl.base) == (len(jl), jl.ints, jl.base)
    np.testing.assert_array_equal(np.asarray(jl.array), tl.array.numpy())
    np.testing.assert_array_equal(np.asarray(jl.sign), np.asarray(tl.sign))
    np.testing.assert_array_equal(jl.to_float(), tl.to_float())
    for x in (f[5], -f[6], 0.0, -1.0):
        js, ts = pair(x, length, ints, base)
        assert ts.to_str() == js.to_str() and str(ts) == str(js)
        assert ts.to_str(False) == js.to_str(False)


def _chain(seed, k=6, length=23, ints=9):
    rng = np.random.RandomState(seed)
    # values inside the integer range whose sums overflow it on some elements
    fs = [rng.uniform(-1, 1, 29) * rng.choice([1.0, 0.99 * 2.0 ** ints], size=29)
          for _ in range(k + 1)]
    return [pair(f, length, ints, 2) for f in fs]


def test_iadd_chain_matches_jax_flags_and_counts():
    pairs = _chain(6)
    (j0, t0), rest = pairs[0], pairs[1:]
    JQFloatBase.reset_stats()
    QFloatBase.reset_stats()
    with jax_track_overflow() as jt:
        j0.iadd_chain([j for j, _ in rest])
    with track_overflow() as tt:
        t0.iadd_chain([t for _, t in rest])
    assert_same(j0, t0)
    np.testing.assert_array_equal(np.asarray(jt.combined()), tt.combined().numpy())
    assert tt.combined().any(), "the chain never overflowed: the flags are untested"
    assert QFloatBase.ADDITIONS == JQFloatBase.ADDITIONS == len(rest)
    # the chain equals the loop of += it stands for
    (_, loop), rest = _chain(6)[0], _chain(6)[1:]
    for _, t in rest:
        loop += t
    assert torch.equal(loop.mag, t0.mag) and torch.equal(torch.as_tensor(loop.sign), t0.sign)
    with pytest.raises(ValueError):
        t0.iadd_chain([SignedBinary(1)])


def test_multi_from_mul_matches_jax():
    rng = np.random.RandomState(7)
    pairs = [pair(rng.randn(13) * 30, 23, 9, 2) for _ in range(8)]
    sb = np.array([1, -1, 0, 1, -1, 1, 1, 0, -1, 1, 0, 1, -1])
    ja = [pairs[0][0], JZero(), JSB(sb), pairs[1][0], pairs[2][0], JSB(1)]
    jb = [pairs[3][0], pairs[4][0], pairs[5][0], JSB(-1), pairs[6][0], JSB(sb)]
    ta = [pairs[0][1], Zero(), SignedBinary(torch.from_numpy(sb)), pairs[1][1], pairs[2][1],
          SignedBinary(1)]
    tb = [pairs[3][1], pairs[4][1], pairs[5][1], SignedBinary(-1), pairs[6][1],
          SignedBinary(torch.from_numpy(sb))]
    for newlength, newints in ((None, None), (21, 11), (30, 12)):
        JQFloatBase.reset_stats()
        QFloatBase.reset_stats()
        with jax_track_overflow() as jt:
            want = JPacked.multi_from_mul(ja, jb, newlength, newints)
        with track_overflow() as tt:
            got = PackedQFloat.multi_from_mul(ta, tb, newlength, newints)
        for w, g in zip(want, got):
            assert_same(w, g)
        # JAX records one flag of the stacked (2, 13) product, the port one a pair
        np.testing.assert_array_equal(np.asarray(jt.combined((13,))), tt.combined().numpy())
        assert QFloatBase.MULTIPLICATION == JQFloatBase.MULTIPLICATION == 2
        # untracked, the truncated multiply gives the same magnitudes
        for w, g in zip(want, PackedQFloat.multi_from_mul(ta, tb, newlength, newints)):
            assert_same(w, g)


def test_multi_invert_matches_jax():
    rng = np.random.RandomState(8)
    f = [rng.randn(17) * 10 for _ in range(4)]
    f[1][:3] = [0.0, 1e-6, 2.0 ** 8]  # zero divisor saturates, tiny ones overflow
    pairs = [pair(x, 23, 9, 2) for x in f]
    for sign, newlength, newints in ((1, None, None), (-1, 23, 0), (JSB(-1), 12, 4)):
        tsign = SignedBinary(-1) if isinstance(sign, JSB) else sign
        JQFloatBase.reset_stats()
        QFloatBase.reset_stats()
        with jax_track_overflow() as jt:
            want = JPacked.multi_invert([j for j, _ in pairs], sign, newlength, newints)
        with track_overflow() as tt:
            got = PackedQFloat.multi_invert([t for _, t in pairs], tsign, newlength, newints)
        for w, g in zip(want, got):
            assert_same(w, g)
        np.testing.assert_array_equal(np.asarray(jt.combined()), tt.combined().numpy())
        assert QFloatBase.DIVISION == JQFloatBase.DIVISION == len(pairs)
    with pytest.raises(ValueError):
        PackedQFloat.multi_invert([pairs[0][1]], 2)


def test_zero_and_signed_binary_match_jax():
    assert Zero().to_float() == JZero().to_float() == 0.0
    v = np.array([1, -1, 0, 1])
    jsb, tsb = JSB(v), SignedBinary(torch.from_numpy(v))
    assert jsb.encrypted is False  # a numpy value is not on the device in JAX
    assert tsb.encrypted is True
    assert JSB(1).encrypted is False and SignedBinary(1).encrypted is False
    assert JSB(jnp.asarray(v)).encrypted is True
    np.testing.assert_array_equal(JSB(jnp.asarray(v)).to_float(), tsb.to_float())
    assert tsb.to_float().dtype == np.float64
    assert JSB(-1).to_float() == SignedBinary(-1).to_float() == -1.0
    for sb in (jsb, tsb):
        sb.value = -1
        assert sb.value == -1 and sb.to_float() == -1.0


def test_qfloat_encrypted_and_fhe_no_ops_match_jax():
    digits = np.random.RandomState(9).randint(0, 2, size=(3, 12))
    jq, tq = JQFloat(digits, 6, 2), QFloat(digits, 6, 2)
    assert jq.encrypted is True and tq.encrypted is True
    assert JQFloatBase.check_convert_fhe(jq, True) is None
    assert QFloatBase.check_convert_fhe(tq, True) is None
    assert QFloat.check_convert_fhe(tq, False) is None
    assert jq.self_check_convert_fhe(True) is None and tq.self_check_convert_fhe(True) is None
    _, tp = pair(1.5, 23, 9, 2)
    assert tp.self_check_convert_fhe(True) is None


@pytest.mark.parametrize("n", [2, 3])
def test_packed_io_takes_jax_arguments(n):
    """``tensorize`` the eighth argument, ``vectorize_rows`` and ``lowering``
    by keyword, as in the JAX package: the same bits, flags included."""
    p = mt.LOW.replace(n=n)
    args = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    M = np.random.RandomState(10 + n).randn(11, n, n) * 100
    M[0, 1] = M[0, 0] * (1 + 1e-12)  # overflows
    mags, signs = float_matrix_to_mags_and_signs(M, *args[1:4])
    tm, ts = torch.from_numpy(mags), torch.from_numpy(signs)
    jm, js = jnp.asarray(mags), jnp.asarray(signs)
    want = jax_inverse.qfloat_matrix_inverse_packed_io(jm, js, *args, True, False, lowering="unroll")
    for got in (mt.qfloat_matrix_inverse_packed_io(tm, ts, *args, True, False),
                mt.qfloat_matrix_inverse_packed_io(tm, ts, *args, tensorize=True,
                                                   vectorize_rows=True, lowering="scan"),
                mt.qfloat_matrix_inverse_packed_io(tm, ts, *args)):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    want = jax_inverse.qfloat_matrix_inverse_with_overflow(jm, js, *args, True, "unroll")
    assert int(np.asarray(want[2])[0]) == 1
    for got in (mt.qfloat_matrix_inverse_with_overflow(tm, ts, *args, True, "unroll"),
                mt.qfloat_matrix_inverse_with_overflow(tm, ts, *args, tensorize=True)):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
