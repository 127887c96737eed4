"""Host-side radix conversion: floats/ints <-> base-p digit arrays, in numpy.

Port of ``matrix_inversion_tpu/ops/radix.py:17-151`` (reference
base_p_arrays.py:11-81), vectorized over a leading batch shape, with the
same summation orders.  Digit arrays are most-significant-digit first
(digit j of an ``n``-digit array has place value ``p**(n-1-j)``).

Quantization (:func:`float_to_digits_and_sign`) follows the JAX package's
native route (``native/qmarshal.cc:60-107``) at every size, as the port's
packed quantize does: an integer part wider than ``ints`` digits keeps its
low ``ints`` digits (it is taken mod ``base**ints``), where the JAX radix
route would return a top digit >= base.  For a power-of-two base with
``bits * len <= 62`` it is the closed form :func:`float_to_mags_and_sign`
(one scale and truncate, digits peeled by shifts); otherwise the
reference's float64 multiply-truncate loop, step for step.  On values whose
integer part fits, both routes of the JAX package and this one agree.
"""

from __future__ import annotations

import numpy as np


def int_to_base_p(integers, n: int, p: int) -> np.ndarray:
    """(Batched) integers -> signed base-p digit arrays, trailing axis ``n``:
    the digits of ``|x|`` times ``sign(x)`` (reference base_p_arrays.py:24-48)."""
    integers = np.asarray(integers)
    if n == 0:
        return np.zeros(integers.shape + (0,), dtype=np.int64)
    if p <= 1:
        raise ValueError("Invalid input values")
    sgn = np.sign(integers).astype(np.int64)
    mag = np.abs(integers).astype(np.int64)
    digits = np.zeros(integers.shape + (n,), dtype=np.int64)
    for i in reversed(range(n)):
        power = p ** i
        div = mag // power
        mag = mag - div * power
        digits[..., n - 1 - i] = div
    return digits * sgn[..., None]


def float_to_base_p(f, precision: int, p: int) -> np.ndarray:
    """(Batched) floats in (-1, 1) -> signed base-p fraction digits, digit i
    of place value ``p**-(i+1)``: the float64 multiply-truncate loop of
    reference base_p_arrays.py:62-81, step for step."""
    f = np.asarray(f, dtype=np.float64)
    sgn = np.sign(f)
    mag = np.abs(f)
    if np.any(mag >= 1.0):
        raise AssertionError("Input should be a float between 0 and 1 (exclusive)")
    digits = np.zeros(f.shape + (precision,), dtype=np.int64)
    for i in range(precision):
        mag = mag * p
        d = mag.astype(np.int64)  # truncation toward zero, like int(f)
        mag = mag - d
        digits[..., i] = d
    return digits * sgn[..., None].astype(np.int64)


def base_p_to_int(digits, p: int):
    """Signed base-p digit array (trailing axis) -> integers (reference
    base_p_arrays.py:11-21)."""
    digits = np.asarray(digits, dtype=np.int64)
    n = digits.shape[-1]
    place = p ** np.arange(n - 1, -1, -1, dtype=np.int64)
    return np.sum(digits * place, axis=-1)


def base_p_to_float(digits, p: int):
    """Signed base-p fraction digits -> float 0.xxx, added one digit at a
    time from the most significant (reference base_p_arrays.py:51-59)."""
    digits = np.asarray(digits, dtype=np.float64)
    n = digits.shape[-1]
    out = np.zeros(digits.shape[:-1], dtype=np.float64)
    for i in range(n):
        out = out + digits[..., i] * (float(p) ** -(i + 1))
    return out


def float_to_mags_and_sign(f, length: int, ints: int, bits: int):
    """(Batched) floats -> (int64 magnitudes, int64 signs) at base
    ``2**bits``: the closed form of ``native/qmarshal.cc:119-141``.

    At a power-of-two base every step of the multiply-truncate fraction
    loop is exact in float64, so the loop computes
    ``floor(|frac| * 2**fp_bits)``; the integer digits are the low
    ``bits * ints`` bits of ``trunc(|x|)``.  The sign of 0.0 is +1.
    """
    f = np.asarray(f, dtype=np.float64)
    fp_bits = bits * (length - ints)
    af = np.abs(f)
    int_part = np.trunc(af)
    int_mag = int_part.astype(np.int64) & ((1 << (bits * ints)) - 1)
    frac_mag = ((af - int_part) * float(2**fp_bits)).astype(np.int64)
    signs = np.where(f < 0, -1, 1).astype(np.int64)
    return (int_mag << fp_bits) | frac_mag, signs


def float_to_digits_and_sign(f, length: int, ints: int, p: int):
    """Quantize (batched) floats to (|digits|, sign) in the QFloat layout:
    ``ints`` integer digits, then ``length - ints`` fraction digits, both
    int64; the sign of 0.0 is +1 (reference qfloat.py:375-397).

    The JAX package's native route at every size (module docstring): an
    integer part wider than ``ints`` digits keeps its low digits.
    """
    f = np.asarray(f, dtype=np.float64)
    bits = p.bit_length() - 1
    if p & (p - 1) == 0 and bits * length <= 62:
        mags, sign = float_to_mags_and_sign(f, length, ints, bits)
        shifts = bits * np.arange(length - 1, -1, -1, dtype=np.int64)
        return (mags[..., None] >> shifts) & (p - 1), sign
    integer_part = f.astype(np.int64)  # trunc toward zero, like int(f)
    float_part = f - integer_part
    # the low `ints` digits of |integer part|, peeled as the native loop does
    mag = np.abs(integer_part)
    int_digits = np.zeros(f.shape + (ints,), dtype=np.int64)
    for j in range(ints - 1, -1, -1):
        int_digits[..., j] = mag % p
        mag = mag // p
    frac_digits = np.abs(float_to_base_p(float_part, length - ints, p))
    sign = np.where(f < 0, -1, 1).astype(np.int64)
    return np.concatenate([int_digits, frac_digits], axis=-1), sign


def digits_and_sign_to_float(digits, sign, ints: int, p: int):
    """Inverse of :func:`float_to_digits_and_sign` (reference
    qfloat.py:399-410)."""
    digits = np.asarray(digits)
    integer_part = base_p_to_int(digits[..., :ints], p).astype(np.float64)
    float_part = base_p_to_float(digits[..., ints:], p)
    return (integer_part + float_part) * np.asarray(sign, dtype=np.float64)


def pack_digits(digits, p: int):
    """Digit arrays -> int64 magnitudes ``sum_j digits[..., j] * p**(L-1-j)``;
    requires ``p**L < 2**63``."""
    digits = np.asarray(digits, dtype=np.int64)
    n = digits.shape[-1]
    place = p ** np.arange(n - 1, -1, -1, dtype=np.int64)
    return np.sum(digits * place, axis=-1)


def unpack_digits(mag, length: int, p: int):
    """int64 magnitudes -> digit arrays (trailing axis ``length``)."""
    mag = np.asarray(mag, dtype=np.int64)
    digits = np.zeros(mag.shape + (length,), dtype=np.int64)
    for i in range(length - 1, -1, -1):
        digits[..., i] = mag % p
        mag = mag // p
    return digits
