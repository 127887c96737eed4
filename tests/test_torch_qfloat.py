"""``core.qfloat.QFloat``, the limb backend's number type, against the JAX
package's ``QFloat`` on the same numpy inputs, on the CPU.

Each method is run on a port QFloat and a JAX QFloat made from the same
digits and signs, at bases 2, 3, 10 and 16, and the results are compared
with tolerance 0: digits, signs, the encoding (length, ints, tidiness) and
the op counters (``QFloatBase.ADDITIONS``, ``MULTIPLICATION``,
``DIVISION``), which are process globals of each package and are reset
before each comparison.  JAX's QFloat takes its digit chains from its
``ops/limbs.py``, which run eagerly would trace every scan anew at every
call; this module runs them jitted (the same functions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_inversion_tpu.core import qfloat as jq
from matrix_inversion_tpu.ops import limbs as jax_limbs

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core import qfloat as pq
from matrix_inversion_tpu_torch.ops import packed

torch.set_num_threads(2)

BASES = (2, 3, 10, 16)
FORMATS = {2: (24, 10), 3: (14, 6), 10: (9, 4), 16: (8, 3)}  # (len, ints) per base


@pytest.fixture(autouse=True, scope="module")
def jitted_jax_chains():
    patch = pytest.MonkeyPatch()
    for name, static in (("base_p_division", (2,)), ("base_tidy", (1,)),
                         ("tidy_to_sign_mag", (1,)), ("is_greater_or_equal", ()),
                         ("is_equal", ())):
        patch.setattr(jax_limbs, name, jax.jit(getattr(jax_limbs, name), static_argnums=static))
    yield
    patch.undo()


def pair(digits, signs, ints, base, tidy=True):
    """A port QFloat and a JAX QFloat of the same digits and signs."""
    sp = signs if isinstance(signs, int) else torch.from_numpy(np.array(signs))
    sj = signs if isinstance(signs, int) else jnp.asarray(signs)
    return (pq.QFloat(torch.from_numpy(np.array(digits)), ints, base, tidy, sp),
            jq.QFloat(jnp.asarray(digits), ints, base, tidy, sj))


def assert_same(p, j):
    """Port and JAX values agree: cells, or lists of them, or plain arrays."""
    if isinstance(j, list):
        assert isinstance(p, list) and len(p) == len(j)
        for a, b in zip(p, j):
            assert_same(a, b)
        return
    if isinstance(j, jq.Zero):
        assert isinstance(p, pq.Zero)
        return
    if isinstance(j, jq.SignedBinary):
        assert isinstance(p, pq.SignedBinary)
        np.testing.assert_array_equal(np.asarray(p.value), np.asarray(j.value))
        return
    if isinstance(j, jq.QFloat):
        assert isinstance(p, pq.QFloat)
        assert (len(p), p.ints, p.base, p.is_base_tidy) == (len(j), j.ints, j.base, j.is_base_tidy)
        np.testing.assert_array_equal(p.array.numpy(), np.asarray(j.array))
        np.testing.assert_array_equal(np.broadcast_to(np.asarray(p.sign), p.bshape),
                                      np.broadcast_to(np.asarray(j.sign), j.bshape))
        return
    np.testing.assert_array_equal(np.asarray(p), np.asarray(j))


def counters():
    return ((pq.QFloatBase.ADDITIONS, pq.QFloatBase.MULTIPLICATION, pq.QFloatBase.DIVISION),
            (jq.QFloatBase.ADDITIONS, jq.QFloatBase.MULTIPLICATION, jq.QFloatBase.DIVISION))


def same_run(fn, *pairs):
    """``fn`` on the port's and the JAX package's operands, counters reset
    before; the results and the counters agree."""
    pq.QFloatBase.reset_stats()
    jq.QFloatBase.reset_stats()
    got = fn(pq, *(p for p, _ in pairs))
    want = fn(jq, *(j for _, j in pairs))
    assert_same(got, want)
    c_port, c_jax = counters()
    assert c_port == c_jax, (c_port, c_jax)
    return got


def operands(rng, base, n=48, length=None, ints=None):
    length, ints = length or FORMATS[base][0], ints or FORMATS[base][1]
    d = rng.randint(0, base, size=(n, length)).astype(np.int32)
    d[: n // 4, : ints] = 0  # small values
    s = rng.choice([-1, 1], size=n).astype(np.int64)
    s[:3] = 0  # sign 0 acts as zero
    d[3:6] = 0
    return d, s, ints


def test_constructor():
    d = np.zeros((3, 6), np.int32)
    for bad in ([0, 1], 3):
        for mod in (pq, jq):
            with pytest.raises(ValueError, match="array"):
                mod.QFloat(bad)
    for mod, arr in ((pq, torch.zeros((), dtype=torch.int32)), (jq, jnp.zeros(()))):
        with pytest.raises(ValueError, match="digit axis"):
            mod.QFloat(arr)
    for kw in (dict(base=1), dict(base=2.0), dict(ints=7), dict(ints=-1)):
        for mod, arr in ((pq, torch.from_numpy(d)), (jq, jnp.asarray(d))):
            with pytest.raises(ValueError):
                mod.QFloat(arr, **kw)
    p, j = pq.QFloat(d, None, 3, True, -1.0), jq.QFloat(d, None, 3, True, -1.0)
    assert p.ints == j.ints == 3 and p.sign == j.sign == -1 and isinstance(p.sign, int)
    assert p.array.dtype == torch.int32 and p.bshape == (3,) and p.device.type == "cpu"
    # an untidy array is tidied at construction
    u = np.array([[0, 3, -5, 7], [1, -1, 0, 2]], np.int32)
    assert_same(*pair(u, 1, 2, 2, tidy=False))


@pytest.mark.parametrize("base", BASES)
def test_float_conversions(base):
    rng = np.random.RandomState(base)
    length, ints = FORMATS[base]
    f = (rng.randint(0, 20000, size=40) - 10000) / 100.0
    f[:2] = 0.0
    p = pq.QFloat.from_float(f, length, ints, base)
    j = jq.QFloat.from_float(f, length, ints, base)
    assert_same(p, j)
    np.testing.assert_array_equal(p.to_float(), j.to_float())
    for x in (13.75, -13.75, 0.0, 2.5):
        ps, js = pq.QFloat.from_float(x, length, ints, base), jq.QFloat.from_float(x, length, ints,
                                                                                    base)
        assert isinstance(ps.sign, int) and ps.sign == js.sign
        assert str(ps) == str(js) and ps.to_str(False) == js.to_str(False)
        assert ps.to_float() == js.to_float()
    zero_sign = pq.QFloat.from_float(1.0, length, ints, base)
    zero_sign._sign = 0
    jzero = jq.QFloat.from_float(1.0, length, ints, base)
    jzero._sign = 0
    assert str(zero_sign) == str(jzero)
    with pytest.raises(ValueError, match="unbatched"):
        p.to_str()


def test_factories_copy_and_set_len_ints():
    for mod in (pq, jq):
        mod.QFloatBase.reset_stats()
    assert_same(pq.QFloat.zero(10, 4, 3, (2,)), jq.QFloat.zero(10, 4, 3, (2,)))
    assert_same(pq.QFloat.one(10, 4, 3, (2,)), jq.QFloat.one(10, 4, 3, (2,)))
    rng = np.random.RandomState(5)
    d, s, ints = operands(rng, 3, n=8)
    p, j = pair(d, s, ints, 3)
    assert_same(pq.QFloat.zero_like(p), jq.QFloat.zero_like(j))
    assert_same(pq.QFloat.one_like(p), jq.QFloat.one_like(j))
    assert_same(p.copy(), j.copy())
    assert p.to_array() is p.array and p.to_digits() is p.array
    for newlen, newints in ((20, 9), (14, 6), (10, 2), (16, 4), (12, 8), (5, 6)):
        assert_same(p.copy().set_len_ints(newlen, newints), j.copy().set_len_ints(newlen, newints))


@pytest.mark.parametrize("base", BASES)
def test_tidy_and_comparisons(base):
    rng = np.random.RandomState(10 + base)
    d, s, ints = operands(rng, base)
    e = d.copy()
    e[::2] = d[::2]  # some equal pairs
    e[1::2] = rng.randint(0, base, size=e[1::2].shape)
    t = rng.choice([-1, 0, 1], size=len(s)).astype(np.int64)
    t[::2] = s[::2]
    a, b = pair(d, s, ints, base), pair(e, t, ints, base)
    same_run(lambda m, x, y: x == y, a, b)
    for op in (lambda m, x, y: x > y, lambda m, x, y: x < y, lambda m, x, y: x <= y,
               lambda m, x, y: x >= y):
        same_run(op, a, b)
    u = rng.randint(-3 * base, 3 * base, size=d.shape).astype(np.int32)

    def tidied(m, x):
        x.tidy()
        return x

    same_run(tidied, pair(u, s, ints, base, tidy=False))
    same_run(tidied, a)
    untidy = pair(u, 1, ints, base, tidy=False)
    for x in untidy:
        x._is_base_tidy = False
    with pytest.raises(Exception, match="not tidy"):
        untidy[0] == a[0]
    with pytest.raises(ValueError, match="different length"):
        a[0] == pq.QFloat.zero(len(a[0]) + 1, ints, base)
    with pytest.raises(ValueError, match="bases"):
        a[0] > pq.QFloat.zero(len(a[0]), ints, base + 1)


@pytest.mark.parametrize("base", BASES)
def test_addition(base):
    rng = np.random.RandomState(20 + base)
    d, s, ints = operands(rng, base)
    e, t, _ = operands(rng, base)
    a, b = pair(d, s, ints, base), pair(e, t, ints, base)
    same_run(lambda m, x, y: x + y, a, b)
    same_run(lambda m, x, y: x - y, a, b)
    same_run(lambda m, x, y: y - x, a, b)
    same_run(lambda m, x: x + m.SignedBinary(1), a)
    same_run(lambda m, x: x + m.SignedBinary(-1), a)
    bits = rng.choice([-1, 0, 1], size=len(s))
    same_run(lambda m, x: x + m.SignedBinary(torch.from_numpy(bits) if m is pq
                                             else jnp.asarray(bits)), a)
    same_run(lambda m, x: m.SignedBinary(-1) - x, a)
    same_run(lambda m, x: x + 3, a)
    same_run(lambda m, x: x + (torch.from_numpy(bits) if m is pq else jnp.asarray(bits)), a)
    same_run(lambda m, x: x - m.SignedBinary(1), a)

    def plus_zero(m, x):
        y = x.copy()
        z = y.__iadd__(m.Zero())
        assert z is y
        return z

    same_run(plus_zero, a)
    same_run(lambda m, x: m.Zero() + x, a)
    same_run(lambda m, x: -x, a)
    same_run(lambda m, x: x.copy().neg(), a)
    same_run(lambda m, x: abs(x), a)
    same_run(lambda m, x: x.copy().abs(), a)


@pytest.mark.parametrize("base", BASES)
def test_multiplication(base):
    rng = np.random.RandomState(30 + base)
    d, s, ints = operands(rng, base)
    e, t, _ = operands(rng, base)
    length = FORMATS[base][0]
    a, b = pair(d, s, ints, base), pair(e, t, ints, base)
    same_run(lambda m, x, y: x * y, a, b)
    same_run(lambda m, x: x * 3, a)
    same_run(lambda m, x: x * -2, a)
    k = rng.randint(-3, 4, size=len(s))
    same_run(lambda m, x: x * (torch.from_numpy(k) if m is pq else jnp.asarray(k)), a)
    same_run(lambda m, x: x * m.SignedBinary(-1), a)
    same_run(lambda m, x: m.SignedBinary(-1) * x, a)
    same_run(lambda m, x: x * m.Zero(), a)
    formats = ((2 * ints + 3, 2 * ints), (length - 3, ints - 1)) if base == 2 else \
        ((length + 4, ints + 2),)
    for newlength, newints in formats:
        same_run(lambda m, x, y: m.QFloat.from_mul(x, y, newlength, newints), a, b)
        same_run(lambda m, x: m.QFloat.from_mul(m.SignedBinary(-1), x, newlength, newints), a)
        same_run(lambda m, x: m.QFloat.from_mul(x, m.Zero(), newlength, newints), a)
        same_run(lambda m, x, y: m.qf_multi_from_mul(
            [x, m.Zero(), m.SignedBinary(1), y, m.SignedBinary(-1)],
            [y, x, x, x, m.SignedBinary(-1)], newlength, newints), a, b)
    same_run(lambda m, x, y: m.QFloat.from_mul(x, y), a, b)
    same_run(lambda m, x, y: m.QFloat.multi_from_mul([x, y], [y, y]), a, b)
    same_run(lambda m, x, y: m.qf_from_mul(x, y, length, ints), a, b)
    with pytest.raises(ValueError, match="bases"):
        pq.QFloat.from_mul(a[0], pq.QFloat.zero(length, ints, base + 1))


@pytest.mark.parametrize("base", BASES)
def test_division(base):
    """True division, the SignedBinary pass-through and saturation, and the
    reciprocal at its own format and a wider and a narrower one, grouped
    and not; the wide bases divide at one small format only (JAX compiles a
    division a shape, seconds at base 16)."""
    rng = np.random.RandomState(40 + base)
    length, ints = FORMATS[base] if base <= 3 else (5, 2)
    d, s, _ = operands(rng, base, 16, length, ints)
    e, t, _ = operands(rng, base, 16, length, ints)
    e[6:9] = 0  # zero divisors saturate
    a, b = pair(d, s, ints, base), pair(e, t, ints, base)
    same_run(lambda m, x, y: x / y, a, b)
    bits = rng.choice([-1, 0, 1], size=len(s))
    for sb in (1, -1, 0):
        same_run(lambda m, x: x / m.SignedBinary(sb), a)
    same_run(lambda m, x: x / m.SignedBinary(torch.from_numpy(bits) if m is pq
                                             else jnp.asarray(bits)), a)
    same_run(lambda m, x: m.Zero() / x, b)
    formats = {2: ((length, 0), (length + 3, 1), (4, 1)), 3: ((length, 0), (4, 1))}
    for newlength, newints in formats.get(base, ()):
        same_run(lambda m, x: x.invert(-1, newlength, newints), b)
        same_run(lambda m, x: x.invert(m.SignedBinary(1), newlength, newints), b)
    if base <= 3:
        same_run(lambda m, x: m.SignedBinary(-1) / x, b)
        same_run(lambda m, x: x.invert(), b)
        same_run(lambda m, x, y: m.qf_multi_invert([x, y, x], -1, length, 0), a, b)
        same_run(lambda m, x, y: m.QFloat.multi_invert([x, y]), a, b)
    for bad in (2, 1.0):
        with pytest.raises(ValueError, match="sign"):
            b[0].invert(bad)
    with pytest.raises(ValueError, match="Zero"):
        a[0] / pq.Zero()


def test_blend_from_blends_digits_not_signs():
    rng = np.random.RandomState(50)
    d, s, ints = operands(rng, 10)
    e, t, _ = operands(rng, 10)
    cond = rng.randint(0, 2, size=len(s))
    same_run(lambda m, x, y: x.copy().blend_from(
        y, torch.from_numpy(cond) if m is pq else jnp.asarray(cond)), pair(d, s, ints, 10),
        pair(e, t, ints, 10))


def test_dispatch_helpers():
    rng = np.random.RandomState(60)
    d, s, ints = operands(rng, 2, n=6)
    p, _ = pair(d, s, ints, 2)
    assert pq.qf_class_of(pq.Zero(), p) is pq.QFloat
    assert pq.qf_class_of([pq.Zero(), p], []) is pq.QFloat
    assert pq.qf_class_of(pq.Zero(), [pq.SignedBinary(1)]) is None
    # the packed backend has no grouped multiply or reciprocal: pair by pair,
    # in the format the grouped one would choose
    length, ints = 24, 10
    mags = torch.from_numpy(rng.randint(1, 1 << 20, size=(3, 6)))
    x = [packed.PackedQFloat(m, length, ints, 2, 1) for m in mags]
    grouped = pq.qf_multi_from_mul([pq.SignedBinary(-1), x[0], pq.Zero()], [x[1], x[2], x[0]])
    assert isinstance(grouped[2], pq.Zero)
    assert torch.equal(grouped[0].mag, x[1].mag) and grouped[0].sign == -1
    assert torch.equal(grouped[1].mag, pq.qf_from_mul(x[0], x[2]).mag)
    inverted = pq.qf_multi_invert(x, -1, length, 0)
    assert all(torch.equal(i.mag, y.invert(-1, length, 0).mag) for i, y in zip(inverted, x))
    assert mt.QFloat is pq.QFloat
