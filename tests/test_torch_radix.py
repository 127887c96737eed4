"""Port vs JAX package: host radix conversion (``ops/radix.py``).

Every function is held exactly to ``matrix_inversion_tpu.ops.radix`` on the
same numpy inputs, at bases 2, 3, 10 and 16.  Quantization of values whose
integer part needs more than ``ints`` digits follows the JAX package's
native route (``native/qmarshal.cc``), not its radix loop, which returns a
top digit >= base there: those values are held to the native library,
built with g++ into a temporary directory, and, independently of any
build, to the radix output with the integer part taken mod base**ints.
Dequantization takes the JAX package's route at each size, its radix sum
below 4,096 values and its native library at 4,096 or more (whose sum may
differ from the radix one in the last bit at bases 3 and 10): it is held to
JAX's own function with that library loaded.
"""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from matrix_inversion_tpu.ops import radix as jax_radix
from matrix_inversion_tpu.runtime import native as jax_native

from matrix_inversion_tpu_torch.models import marshal
from matrix_inversion_tpu_torch.ops import radix

REPO = Path(__file__).resolve().parent.parent
BASES = [2, 3, 10, 16]
# (base, len, ints): the closed form at the power-of-two bases with
# bits * len <= 62, the multiply-truncate loop at the others and at base 2
# with 70 digits
FORMATS = [(2, 40, 20), (2, 70, 30), (3, 20, 8), (10, 12, 5), (16, 12, 6)]


def in_range(rng, base, ints, size):
    """Values whose integer part fits ``ints`` digits, with zeros, -0.0 and
    exact integers among them."""
    top = min(float(base) ** ints, 1e15)
    f = rng.uniform(-1, 1, size=size) * top * rng.choice([1e-6, 1e-3, 1.0], size=size)
    f[:6] = [0.0, -0.0, 1.0, -1.0, 0.5, -(top - 1)]
    return f


def overflowing(rng, base, ints, size):
    """Values whose integer part needs up to 8 digits more than ``ints``."""
    top = float(base) ** ints
    return rng.uniform(-1, 1, size=size) * top * rng.choice([2.0, 7.5, float(base) ** 8], size=size)


@pytest.mark.parametrize("p", BASES)
def test_int_digits_match_jax(p):
    rng = np.random.RandomState(p)
    xs = rng.randint(-(p ** 6), p ** 6, size=(5, 50))
    xs[0, :3] = [0, p ** 6 - 1, -(p ** 6) + 1]
    got = radix.int_to_base_p(xs, 7, p)
    np.testing.assert_array_equal(got, jax_radix.int_to_base_p(xs, 7, p))
    assert got.dtype == np.int64 and got.shape == (5, 50, 7)
    np.testing.assert_array_equal(radix.base_p_to_int(got, p), jax_radix.base_p_to_int(got, p))
    np.testing.assert_array_equal(radix.base_p_to_int(got, p), xs)
    assert radix.int_to_base_p(xs, 0, p).shape == (5, 50, 0)
    with pytest.raises(ValueError):
        radix.int_to_base_p(xs, 3, 1)


@pytest.mark.parametrize("p", BASES)
def test_fraction_digits_match_jax(p):
    xs = np.random.RandomState(p).uniform(-1, 1, size=(4, 64)) * 0.999
    xs[0, :2] = [0.0, -0.0]
    got = radix.float_to_base_p(xs, 30, p)
    np.testing.assert_array_equal(got, jax_radix.float_to_base_p(xs, 30, p))
    # the sequential sum, bit for bit
    np.testing.assert_array_equal(radix.base_p_to_float(got, p), jax_radix.base_p_to_float(got, p))
    with pytest.raises(AssertionError):
        radix.float_to_base_p(np.array([1.0]), 4, p)


@pytest.mark.parametrize("p,length,ints", FORMATS)
@pytest.mark.parametrize("size", [300, 5000])  # JAX: radix loop; native route where built
def test_quantize_in_range_matches_jax(native_lib, p, length, ints, size):
    f = in_range(np.random.RandomState(size + p), p, ints, size).reshape(-1, 4)
    digits, signs = radix.float_to_digits_and_sign(f, length, ints, p)
    ref_d, ref_s = jax_radix.float_to_digits_and_sign(f, length, ints, p)
    assert digits.dtype == np.int64 and signs.dtype == np.int64
    assert digits.shape == f.shape + (length,) and signs.shape == f.shape
    np.testing.assert_array_equal(digits, ref_d)
    np.testing.assert_array_equal(signs, ref_s)
    assert signs.flat[0] == 1 and signs.flat[1] == 1  # 0.0 and -0.0 have sign +1
    back = radix.digits_and_sign_to_float(digits, signs, ints, p)
    np.testing.assert_array_equal(back, jax_radix.digits_and_sign_to_float(digits, signs, ints, p))


@pytest.mark.parametrize("p", BASES)
def test_dequantize_matches_jax(native_lib, p):
    rng = np.random.RandomState(p)
    digits = rng.randint(0, p, size=(600, 9, 14))
    signs = rng.choice([-1, 0, 1], size=(600, 9))
    got = radix.digits_and_sign_to_float(digits, signs, 6, p)
    assert got.shape == (600, 9)
    np.testing.assert_array_equal(got, jax_radix.digits_and_sign_to_float(digits, signs, 6, p))


@pytest.mark.parametrize("p,length", [(2, 35), (3, 30), (10, 15), (16, 12)])
def test_pack_unpack_match_jax(p, length):
    digits = np.random.RandomState(p).randint(0, p, size=(40, 3, length))
    digits[0, 0] = p - 1
    mags = radix.pack_digits(digits, p)
    np.testing.assert_array_equal(mags, jax_radix.pack_digits(digits, p))
    np.testing.assert_array_equal(radix.unpack_digits(mags, length, p),
                                  jax_radix.unpack_digits(mags, length, p))
    np.testing.assert_array_equal(radix.unpack_digits(mags, length, p), digits)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The JAX package's native marshaller, built with g++ from
    ``native/qmarshal.cc`` into a temporary directory (so that no other
    test's build in ``native/build/`` is raced), loaded for this module and
    unloaded after it."""
    out = tmp_path_factory.mktemp("qmarshal") / "libqmarshal.so"
    build = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         str(REPO / "native" / "qmarshal.cc"), "-o", str(out)],
        capture_output=True, text=True,
    )
    assert build.returncode == 0, build.stderr
    saved = jax_native._LIB, jax_native._TRIED, os.environ.get("QMARSHAL_LIB")
    os.environ["QMARSHAL_LIB"] = str(out)
    jax_native._LIB, jax_native._TRIED = None, False
    try:
        assert jax_native.available()
        yield jax_native
    finally:
        jax_native._LIB, jax_native._TRIED = saved[:2]
        if saved[2] is None:
            del os.environ["QMARSHAL_LIB"]
        else:
            os.environ["QMARSHAL_LIB"] = saved[2]


@pytest.mark.parametrize("p,length,ints", FORMATS)
def test_quantize_overflowing_matches_native_route(native_lib, p, length, ints):
    rng = np.random.RandomState(10 + p)
    f = np.concatenate([overflowing(rng, p, ints, 200), in_range(rng, p, ints, 56)])
    digits, signs = radix.float_to_digits_and_sign(f, length, ints, p)
    nat_d, nat_s = native_lib.quantize_digits(f, length, ints, p)
    np.testing.assert_array_equal(digits, nat_d)
    np.testing.assert_array_equal(signs, nat_s)
    # the JAX radix route gives a top digit >= base on the same values
    assert (jax_radix.float_to_digits_and_sign(f[:200], length, ints, p)[0][:, 0] >= p).any()


@pytest.mark.parametrize("p,length,ints", FORMATS)
def test_quantize_overflowing_matches_radix_mod_base_ints(p, length, ints):
    """Without the native build: JAX's radix digits of the integer part
    taken mod base**ints, and of the fraction as they are."""
    rng = np.random.RandomState(20 + p)
    f = overflowing(rng, p, ints, 256)
    int_part = f.astype(np.int64)
    want = np.concatenate([
        jax_radix.int_to_base_p(np.abs(int_part) % p ** ints, ints, p),
        np.abs(jax_radix.float_to_base_p(f - int_part, length - ints, p)),
    ], axis=-1)
    digits, signs = radix.float_to_digits_and_sign(f, length, ints, p)
    np.testing.assert_array_equal(digits, want)
    np.testing.assert_array_equal(signs, np.where(f < 0, -1, 1))
    assert (digits < p).all()


@pytest.mark.parametrize("p,length,ints", [f for f in FORMATS if f[0] in (2, 16) and f[1] <= 40])
def test_digit_and_packed_quantize_agree(p, length, ints):
    """Packing the digit quantize gives the packed quantize, overflowing
    values included."""
    rng = np.random.RandomState(30 + p)
    M = np.concatenate([overflowing(rng, p, ints, 64), in_range(rng, p, ints, 64)]).reshape(8, 4, 4)
    digits, signs = marshal.float_matrix_to_qfloat_arrays(M, length, ints, p)
    mags, psigns = marshal.float_matrix_to_mags_and_signs(M, length, ints, p)
    assert digits.shape == (8, 16, length) and mags.shape == (8, 16)
    np.testing.assert_array_equal(radix.pack_digits(digits, p), mags)
    np.testing.assert_array_equal(signs, psigns)
