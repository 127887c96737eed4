"""Packed-I/O marshalling: float matrices <-> int64 magnitudes and signs.

Port of the packed part of ``matrix_inversion_tpu/models/marshal.py``
(``:113-213``).  Quantization is the closed form of the native marshaller
(``native/qmarshal.cc:119-141``), vectorised in numpy: for a power-of-two
base every step of the reference's multiply-truncate digit loop is exact
in float64, so the loop computes ``floor(|frac| * 2**fp_bits)``, and the
integer digits are the low ``bits * ints`` bits of ``trunc(|x|)``.  No
digit array is built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.qfloat import QFloatBase, SignedBinary, Zero
from ..ops.packed import PackedQFloat, digit_bits


def float_matrix_to_mags_and_signs(M, qfloat_len, qfloat_ints, qfloat_base):
    """Float matrix (..., n, n) -> ((..., n*n) int64 magnitudes, int64 signs).

    An integer part wider than ``ints`` digits keeps its low digits, and
    the sign of 0.0 is +1.
    """
    bits = digit_bits(qfloat_base)
    M = np.asarray(M, dtype=np.float64)
    flat = M.reshape(M.shape[:-2] + (-1,))
    fp_bits = bits * (qfloat_len - qfloat_ints)
    af = np.abs(flat)
    int_part = np.trunc(af)
    int_mag = int_part.astype(np.int64) & ((1 << (bits * qfloat_ints)) - 1)
    frac_mag = ((af - int_part) * float(2**fp_bits)).astype(np.int64)
    mags = (int_mag << fp_bits) | frac_mag
    signs = np.where(flat < 0, -1, 1).astype(np.int64)
    return mags, signs


def mags_and_signs_to_float_matrix(mags, signs, qfloat_len, qfloat_ints, qfloat_base):
    """Packed output -> float matrix (..., n, n) (host side), at any base."""
    mags = np.asarray(mags)
    signs = np.asarray(signs)
    n = int(np.sqrt(mags.shape[-1]))
    frac = qfloat_len - qfloat_ints
    values = (
        mags.astype(np.float64)
        * float(qfloat_base) ** (-frac)
        * signs.astype(np.float64)
    )
    return values.reshape(values.shape[:-1] + (n, n))


def mags_and_signs_to_qfloat_matrix(mags, signs, qfloat_len, qfloat_ints, qfloat_base):
    """(..., n*n) int64 tensors -> n x n 2D list of PackedQFloats."""
    n = int(np.sqrt(mags.shape[-1]))
    return [
        [
            PackedQFloat(
                mags[..., i * n + j], qfloat_len, qfloat_ints, qfloat_base,
                signs[..., i * n + j],
            )
            for j in range(n)
        ]
        for i in range(n)
    ]


def qfloat_matrix_to_mags_and_signs(M, qfloat_len, qfloat_ints, qfloat_base):
    """QFloat 2D-list matrix -> ((..., n*n) magnitudes, (..., n*n) signs).

    SignedBinary cells land at digit ``ints-1``, as in the reference
    encoding.
    """
    like = next(c.mag for row in M for c in row if isinstance(c, PackedQFloat))
    unit = 1 << (digit_bits(qfloat_base) * (qfloat_len - qfloat_ints))
    mags, signs = [], []
    for row in M:
        for cell in row:
            if isinstance(cell, QFloatBase):
                mag, sign = cell.mag, cell.sign
            elif isinstance(cell, SignedBinary):
                mag, sign = abs(cell.value) * unit, cell.value
            elif isinstance(cell, Zero):
                mag, sign = 0, 0
            else:
                raise TypeError(f"unexpected cell type {type(cell).__name__}")
            mags.append(torch.broadcast_to(torch.as_tensor(mag, device=like.device), like.shape))
            signs.append(torch.broadcast_to(torch.as_tensor(sign, device=like.device), like.shape))
    return (
        torch.stack(mags, dim=-1).to(torch.int64),
        torch.stack(signs, dim=-1).to(torch.int64),
    )
