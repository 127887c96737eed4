"""Plain PyTorch reference of the QFloat encodings around the inverse.

Floats to QFloat cells and back, and the digit form of a cell, for a base
``2**bits`` (the reference's ``qfloat.py:375-410`` and
``base_p_arrays.py``).  At such a base every step of the reference's
multiply-truncate fraction loop is exact in float64, so a float's magnitude
is ``trunc(|x|)`` kept mod ``base**ints``, shifted over the fraction, plus
``floor(frac(|x|) * base**frac)``; the sign of 0.0 is +1.  Digits are most
significant first; a digit output carries the sign in one more column.
"""

from __future__ import annotations

import torch


def quantize(floats, length, ints, bits):
    """``(..., n, n)`` float64 tensor -> ``(..., n*n)`` int64 magnitudes and
    signs."""
    f = floats.reshape(floats.shape[:-2] + (-1,)).to(torch.float64)
    frac_bits = bits * (length - ints)
    af = f.abs()
    int_part = torch.trunc(af)
    int_mag = int_part.to(torch.int64) & ((1 << (bits * ints)) - 1)
    frac_mag = ((af - int_part) * float(2 ** frac_bits)).to(torch.int64)
    signs = torch.where(f < 0, -1, 1).to(torch.int64)
    return (int_mag << frac_bits) | frac_mag, signs


def _shifts(length, bits, device):
    return torch.arange(bits * (length - 1), -1, -bits, dtype=torch.int64, device=device)


def to_digits(mags, length, bits):
    """``(...)`` magnitudes -> ``(..., length)`` int64 digits."""
    return (mags.unsqueeze(-1) >> _shifts(length, bits, mags.device)) & ((1 << bits) - 1)


def from_digits(digits, bits):
    """``(..., length)`` digits -> ``(...)`` int64 magnitudes."""
    digits = digits.to(torch.int64)
    return (digits << _shifts(digits.shape[-1], bits, digits.device)).sum(-1)


def digit_output(mags, signs, length, bits):
    """Magnitudes and signs -> ``(..., length + 1)`` int32 digits with the
    sign in the last column."""
    return torch.cat([to_digits(mags, length, bits), signs.unsqueeze(-1)], -1).to(torch.int32)


def dequantize(mags, signs, length, ints, bits, n):
    """Magnitudes and signs -> ``(..., n, n)`` float64 values."""
    scale = 2.0 ** (-bits * (length - ints))
    values = mags.to(torch.float64) * scale * signs.to(torch.float64)
    return values.reshape(values.shape[:-1] + (n, n))


def widen(mags, from_format, to_format, bits):
    """Magnitudes of ``from_format = (length, ints)`` written exactly in the
    wider fraction of ``to_format``: the same values in the other format's
    cells (a narrower result handed on in the configuration's format)."""
    shift = bits * ((to_format[0] - to_format[1]) - (from_format[0] - from_format[1]))
    if shift < 0:
        raise ValueError("the target format has the narrower fraction")
    return mags << shift
