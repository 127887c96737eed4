"""Port vs JAX package: overflow tracking, op by op and end to end.

The same numpy inputs go through the JAX package under its
``track_overflow()`` scope and through the port under its own; values,
signs and the int32 flags must be equal (tolerance 0).  The circuit cases
run JAX's tracked multiply in its unrolled form (``set_mul_scan(False)``:
the same partial products added in the same order as its default scan,
and seconds instead of a compile per multiply on the CPU);
``test_circuit_matches_jax_default_scan`` holds the port to the default.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.core.qfloat import SignedBinary as JSB
from matrix_inversion_tpu.core.qfloat import Zero as JZero
from matrix_inversion_tpu.models.inverse import (
    qfloat_matrix_inverse_packed_io as jax_inverse,
    qfloat_matrix_inverse_with_overflow as jax_inverse_with_overflow,
)
from matrix_inversion_tpu.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu.ops import packed as jax_packed
from matrix_inversion_tpu.ops.packed import OverflowTracker as JTracker
from matrix_inversion_tpu.ops.packed import PackedQFloat as JPacked
from matrix_inversion_tpu.ops.packed import track_overflow as jax_track
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core.qfloat import SignedBinary, Zero
from matrix_inversion_tpu_torch.ops import packed
from matrix_inversion_tpu_torch.ops.packed import (
    OverflowTracker,
    PackedQFloat,
    mul_window_consts,
    mul_window_packed,
    track_overflow,
)

torch.set_num_threads(2)

B = 64


@pytest.fixture
def jax_unrolled_mul(monkeypatch):
    monkeypatch.setattr(jax_packed, "_MUL_SCAN", False)


def qf_pair(mags, length, ints, base, signs):
    """The same QFloat as (JAX PackedQFloat, port PackedQFloat)."""
    mags = np.array(mags, np.int64)
    signs = np.array(signs, np.int64)
    return (
        JPacked(jnp.asarray(mags), length, ints, base, jnp.asarray(signs)),
        PackedQFloat(torch.from_numpy(mags), length, ints, base, torch.from_numpy(signs)),
    )


def rand_pair(rng, length, ints, base=2, near_mask=False, zero_sign=False):
    """Random digits; ``near_mask`` sets the top two digits of half the
    batch to base-1, so that sums of two such values carry out."""
    digits = rng.randint(0, base, size=(B, length))
    if near_mask:
        digits[: B // 2, :2] = base - 1
    bits = base.bit_length() - 1
    mags = sum(digits[:, j].astype(np.int64) << (bits * (length - 1 - j)) for j in range(length))
    signs = rng.choice([-1, 0, 1] if zero_sign else [-1, 1], size=B)
    return qf_pair(mags, length, ints, base, signs)


def assert_same(jp, tp):
    if isinstance(jp, JZero):
        assert isinstance(tp, Zero)
        return
    assert (len(jp), jp.ints, jp.base) == (len(tp), tp.ints, tp.base)
    np.testing.assert_array_equal(np.asarray(jp.mag), tp.mag.numpy())
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(jp.sign), (B,)), np.broadcast_to(np.asarray(tp.sign), (B,))
    )


def both_tracked(jfn, tfn):
    """Run ``jfn`` under JAX tracking and ``tfn`` under the port's; check the
    values and the combined flags; return (flags, number of records)."""
    with jax_track() as jt:
        jout = jfn()
    with track_overflow() as tt:
        tout = tfn()
    assert_same(jout, tout)
    jflag = np.asarray(jt.combined((B,)))
    tflag = tt.combined((B,))
    assert tflag.dtype == torch.int32
    np.testing.assert_array_equal(tflag.numpy(), jflag)
    assert len(tt.flags) == len(jt.flags)
    return tflag.numpy(), len(tt.flags)


# ---- the tracker -----------------------------------------------------------


def test_add_overflow_flagged():
    # 2**8 + 2**8 overflows a (9, 9) all-integer encoding; 3 + 3 does not
    for value, expected in ((1 << 8, 1), (3, 0)):
        with track_overflow() as t:
            x = PackedQFloat(torch.tensor(value), 9, 9, 2)
            _ = x + x
            flag = t.combined()
        assert flag.dtype == torch.int32 and int(flag) == expected
        with jax_track() as jt:
            jx = JPacked(jnp.asarray(value), 9, 9, 2)
            _ = jx + jx
        assert int(np.asarray(jt.combined())) == expected
    assert packed._OVERFLOW_TRACKER is None


def test_combined_reduces_stacked_flags():
    rng = np.random.RandomState(1)
    flags = [rng.rand(5) < 0.2, rng.rand(3, 5) < 0.2, rng.rand(2, 3, 5) < 0.1]
    port, ref = OverflowTracker(), JTracker()
    for f in flags:
        port.record(torch.from_numpy(f))
        ref.record(jnp.asarray(f))
    for shape in ((5,), None):
        got = port.combined(shape)
        assert got.dtype == torch.int32 and got.shape == (5,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.combined(shape)))
    expected = flags[0] | flags[1].any(0) | flags[2].any((0, 1))
    np.testing.assert_array_equal(port.combined((5,)).numpy(), expected.astype(np.int32))


def test_combined_without_flags_is_zeros():
    got = OverflowTracker().combined((4, 3))
    assert got.dtype == torch.int32 and got.shape == (4, 3) and not got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(JTracker().combined((4, 3))))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_combined_without_flags_lies_on_the_named_device(device):
    """A scope that recorded nothing cannot know its operands' device: the
    caller names it, as the tracked circuit does with its inputs'."""
    got = OverflowTracker().combined((4, 3), device=torch.device(device))
    assert got.device.type == device and got.dtype == torch.int32 and got.shape == (4, 3)
    with track_overflow() as tracker:
        pass
    assert tracker.combined((2,), device=device).device.type == device


def test_scopes_nest():
    with track_overflow() as outer:
        with track_overflow() as inner:
            assert packed._OVERFLOW_TRACKER is inner
        assert packed._OVERFLOW_TRACKER is outer
    assert packed._OVERFLOW_TRACKER is None


# ---- each tracked op against JAX ------------------------------------------


@pytest.mark.parametrize("base,fmt", [(2, (23, 9)), (2, (40, 20)), (4, (14, 5)), (16, (9, 4))])
def test_add_near_the_mask(base, fmt):
    rng = np.random.RandomState(base)
    j1, t1 = rand_pair(rng, *fmt, base, near_mask=True)
    j2, t2 = rand_pair(rng, *fmt, base, near_mask=True, zero_sign=True)
    flag, _ = both_tracked(lambda: j1 + j2, lambda: t1 + t2)
    assert 0 < flag.sum() < B
    both_tracked(lambda: j1 - j2, lambda: t1 - t2)
    mask = (1 << ((base.bit_length() - 1) * fmt[0])) - 1
    jm, tm = qf_pair(np.full(B, mask), *fmt, base, np.ones(B))
    flag, _ = both_tracked(lambda: jm + JSB(1), lambda: tm + SignedBinary(1))
    assert flag.all()
    flag, _ = both_tracked(lambda: JSB(-1) - jm, lambda: SignedBinary(-1) - tm)
    assert flag.all()


def test_flag_free_ops_record_nothing():
    rng = np.random.RandomState(2)
    j1, t1 = rand_pair(rng, 23, 9, near_mask=True)
    cases = [
        (lambda: j1 + JZero(), lambda: t1 + Zero()),
        (lambda: j1.copy().set_len_ints(18, 3), lambda: t1.copy().set_len_ints(18, 3)),
        (lambda: j1.copy().set_len_ints(30, 14), lambda: t1.copy().set_len_ints(30, 14)),
        (lambda: j1 / JSB(0), lambda: t1 / SignedBinary(0)),
        (lambda: j1 / JSB(-1), lambda: t1 / SignedBinary(-1)),
        (lambda: j1 * JSB(-1), lambda: t1 * SignedBinary(-1)),
        (lambda: JPacked.from_mul(JSB(1), j1, 30, 5), lambda: PackedQFloat.from_mul(SignedBinary(1), t1, 30, 5)),
        # an uncropped reciprocal: 1 + 14 + 1 digits fit in 23
        (lambda: j1.invert(1, 23, 22), lambda: t1.invert(1, 23, 22)),
    ]
    values = rng.choice([-1, 0, 1], size=B)
    cases.append((lambda: j1 / JSB(jnp.asarray(values)), lambda: t1 / SignedBinary(torch.from_numpy(values))))
    for jfn, tfn in cases:
        flag, records = both_tracked(jfn, tfn)
        assert records == 0 and not flag.any()


def exact_window_sum(a, b, fmt_a, fmt_b, fmt_out, bits):
    """The windowed multiply's partial-product sum in Python integers,
    without the wrap at 2**64."""
    acc = 0
    for a_sh, b_sh, b_mask, o_sh in mul_window_consts(*fmt_a, *fmt_b, *fmt_out, bits):
        acc += ((a >> a_sh) & ((1 << bits) - 1)) * (((b >> b_sh) & b_mask) << o_sh)
    return acc


def test_mul_window_carry_past_2_64_is_not_flagged():
    """Five cropped partial products of 2**62 - small sum past 2**64 but
    leave no bit above the 62-bit window after the wrap: JAX does not flag
    this, and neither may the port (a 128-bit sum would).  Four such
    products stay below 2**64 and flag; one fits the window."""
    fmt = (62, 62)
    b = (1 << 62) - 1
    for a, wraps, flagged in ((31, True, 0), (15, False, 1), (1, False, 0)):
        acc = exact_window_sum(a, b, fmt, fmt, fmt, 1)
        assert (acc >= 1 << 64) == wraps
        ja, ta = qf_pair(np.full(B, a), *fmt, 2, np.ones(B))
        jb, tb = qf_pair(np.full(B, b), *fmt, 2, np.ones(B))
        flag, records = both_tracked(
            lambda: JPacked.from_mul(ja, jb, *fmt), lambda: PackedQFloat.from_mul(ta, tb, *fmt)
        )
        assert records == 1 and (flag == flagged).all()
        mag, ovf = mul_window_packed(ta.mag, *fmt, tb.mag, *fmt, *fmt, 1)
        assert int(mag[0]) == acc % (1 << 64) & ((1 << 62) - 1)
        assert int(ovf[0]) == flagged


@pytest.mark.parametrize("base", [2, 4, 16])
def test_mul_window_formats(base):
    """Random formats, including widening outputs: the windowed (tracked)
    multiply against JAX's, and its magnitudes against the truncated one."""
    rng = np.random.RandomState(10 + base)
    maxlen = {2: 40, 4: 20, 16: 10}[base]
    bits = base.bit_length() - 1
    seen = set()
    for _ in range(8):
        a_len, b_len, nl = rng.randint(2, maxlen + 1, size=3)
        fa = (a_len, rng.randint(0, a_len + 1))
        fb = (b_len, rng.randint(0, b_len + 1))
        ni = rng.randint(0, nl + 1)
        j1, t1 = rand_pair(rng, *fa, base)
        j2, t2 = rand_pair(rng, *fb, base, zero_sign=True)
        flag, _ = both_tracked(
            lambda: JPacked.from_mul(j1, j2, nl, ni), lambda: PackedQFloat.from_mul(t1, t2, nl, ni)
        )
        seen |= set(flag.tolist())
        untracked = PackedQFloat.from_mul(t1, t2, nl, ni)
        np.testing.assert_array_equal(
            mul_window_packed(t1.mag, *fa, t2.mag, *fb, nl, ni, bits)[0], untracked.mag
        )
    assert seen == {0, 1}
    # in-place multiply at the format of the left operand
    j1, t1 = rand_pair(rng, maxlen, maxlen // 2, base)
    j2, t2 = rand_pair(rng, maxlen, maxlen // 2, base)
    both_tracked(lambda: j1 * j2, lambda: t1 * t2)


def test_mul_window_circuit_formats():
    rng = np.random.RandomState(3)
    for fa, fb, (nl, ni) in [
        ((18, 18), (25, 0), (18, 1)),
        ((40, 20), (40, 20), (43, 40)),
        ((43, 40), (43, 40), (40, 0)),
        ((23, 9), (23, 0), (23, 9)),
        ((40, 20), (40, 0), (40, 20)),
    ]:
        j1, t1 = rand_pair(rng, *fa)
        j2, t2 = rand_pair(rng, *fb)
        both_tracked(lambda: JPacked.from_mul(j1, j2, nl, ni), lambda: PackedQFloat.from_mul(t1, t2, nl, ni))


@pytest.mark.parametrize("base,fmt", [(2, (23, 9)), (2, (40, 20)), (4, (14, 5))])
def test_division(base, fmt):
    rng = np.random.RandomState(20 + base)
    j1, t1 = rand_pair(rng, *fmt, base)
    j2, _ = rand_pair(rng, *fmt, base, zero_sign=True)
    mags = np.asarray(j2.mag).copy()
    mags[: B // 4] = rng.randint(0, 16, size=B // 4)  # quotients past the window
    j2, t2 = qf_pair(mags, *fmt, base, np.asarray(j2.sign))
    flag, records = both_tracked(lambda: j1 / j2, lambda: t1 / t2)
    assert records == 1 and 0 < flag.sum() < B
    # a zero divisor saturates all quotient digits, so it flags
    jz, tz = qf_pair(np.zeros(B), *fmt, base, np.ones(B))
    flag, _ = both_tracked(lambda: j1 / jz, lambda: t1 / tz)
    assert flag.all()


@pytest.mark.parametrize("base,fmt", [(2, (23, 9)), (2, (40, 20)), (2, (43, 40)), (4, (14, 5))])
def test_invert_cropped(base, fmt):
    """``invert`` records only when ``newlength < n_digits``."""
    rng = np.random.RandomState(30 + base)
    length, ints = fmt
    j1, _ = rand_pair(rng, *fmt, base, zero_sign=True)
    mags = np.asarray(j1.mag).copy()
    mags[: B // 2] = rng.randint(0, 4, size=B // 2)  # tiny and zero divisors
    j1, t1 = qf_pair(mags, *fmt, base, np.asarray(j1.sign))
    newlength = min(length, 40)
    assert newlength < 1 + (length - ints) + newlength
    flag, records = both_tracked(lambda: j1.invert(1, newlength, 0), lambda: t1.invert(1, newlength, 0))
    assert records == 1 and 0 < flag.sum() < B
    jsb, tsb = JSB(-1), SignedBinary(-1)
    both_tracked(lambda: jsb / j1, lambda: tsb / t1)


# ---- the tracked circuit ----------------------------------------------------


def overflowy_batch(n, seed, B=12):
    """Random x100 matrices, one near-singular (its inverse overflows the
    integer range) and one all-zero (division by zero saturates)."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) * 100
    M[0, 1] = M[0, 0] * (1 + 1e-12)
    M[1] = 0.0
    return M


def check_circuit(name, n, seed):
    p = mi.PRESETS[name].replace(n=n)
    mags, signs = float_matrix_to_mags_and_signs(
        overflowy_batch(n, seed), p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    mags, signs = np.asarray(mags), np.asarray(signs)
    args = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    ref = jax_inverse_with_overflow(jnp.asarray(mags), jnp.asarray(signs), *args, lowering="unroll")
    got = mt.qfloat_matrix_inverse_with_overflow(
        torch.from_numpy(mags), torch.from_numpy(signs), *args, lowering="unroll"
    )
    assert got[2].dtype == torch.int32 and got[2].shape == (12,)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    flags = got[2].numpy()
    assert flags[0] == 1 and flags[1] == 1 and not flags.all()
    return mags, signs, args, got


@pytest.mark.parametrize(
    "name,n",
    [("high", 2), ("high", 3), ("high", 4), ("high", 5), ("low", 3), ("low", 4),
     ("medium", 3), ("medium+", 4)],
)
def test_circuit_matches_jax_tracked_unroll(jax_unrolled_mul, name, n):
    mags, signs, args, got = check_circuit(name, n, seed=n)
    # tracking leaves magnitudes and signs as they are
    untracked = mt.qfloat_matrix_inverse_packed_io(
        torch.from_numpy(mags), torch.from_numpy(signs), *args, lowering="unroll"
    )
    assert torch.equal(untracked[0], got[0]) and torch.equal(untracked[1], got[1])


def test_circuit_grouped_dot_products(jax_unrolled_mul):
    """LOW n=7: JAX groups dot products of length >= 6 (multi_from_mul,
    iadd_chain); the port's sequential ops give the same values and flags."""
    check_circuit("low", 7, seed=7)


def test_circuit_matches_jax_default_scan():
    check_circuit("high", 4, seed=44)


def test_tracking_leaves_values_unchanged():
    """Port of tests/test_overflow.py::test_tracking_off_by_default."""
    p = mi.LOW.replace(n=2)
    M = np.random.RandomState(4).randn(4, 2, 2) * 100
    mags, signs = (np.asarray(x) for x in float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base))
    args = (2, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    base = jax_inverse(jnp.asarray(mags), jnp.asarray(signs), *args)
    tm, ts = torch.from_numpy(mags), torch.from_numpy(signs)
    untracked = mt.qfloat_matrix_inverse_packed_io(tm, ts, *args)
    tracked = mt.qfloat_matrix_inverse_with_overflow(tm, ts, *args)
    for i in range(2):
        np.testing.assert_array_equal(untracked[i].numpy(), np.asarray(base[i]))
        np.testing.assert_array_equal(tracked[i].numpy(), np.asarray(base[i]))
    assert packed._OVERFLOW_TRACKER is None


def test_batched_api_matches_jax():
    p = mt.HIGH.replace(n=3)
    M = overflowy_batch(3, seed=12)
    port = mt.BatchedMatrixInversion(p, 12, io="packed", device="cpu", track_overflow=True)
    ref = JaxBatched(mi.HIGH.replace(n=3), 12, backend="packed", io="packed", track_overflow=True)
    got_inv, got_flags = port.run(M)
    ref_inv, ref_flags = ref.run(M)
    assert got_flags.dtype == np.int32 and got_flags.shape == (12,)
    np.testing.assert_array_equal(got_flags, np.asarray(ref_flags))
    np.testing.assert_array_equal(got_inv, ref_inv)
    assert got_flags[0] == 1 and got_flags[1] == 1
    ok = got_flags == 0
    assert np.max(np.abs(got_inv[ok] - np.linalg.inv(M[ok]))) < 1e-3
    out = port.run_raw(*port.quantize(M))
    assert len(out) == 3 and out[2].dtype == torch.int32
    inv, flags = port.dequantize(out)
    np.testing.assert_array_equal(inv, got_inv)
    np.testing.assert_array_equal(flags, got_flags)
