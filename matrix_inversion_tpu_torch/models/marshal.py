"""Marshalling between float matrices, digit-array I/O, packed I/O and
QFloat matrices.

Port of ``matrix_inversion_tpu/models/marshal.py`` (``:23-227``).  Every
converter takes leading batch dimensions.  The host
converters take the native marshaller (``runtime/native.py``) at 4,096
values or more, as the JAX package's do, and numpy below that: packed
quantization is then the closed form of the native marshaller
(``ops/radix.py::float_to_mags_and_sign``, ``native/qmarshal.cc:119-141``),
vectorised, and digit quantization peels the same magnitudes into digits
(``ops/radix.py::float_to_digits_and_sign``).  The quantizers take ``out``,
arrays to write into (the stream's pinned host buffers).  The converter
that builds QFloat cells from digits takes either backend: "limb" digit
arrays (:class:`~..core.qfloat.QFloat`, any base) or "packed" int64
magnitudes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.qfloat import QFloat, QFloatBase, SignedBinary, Zero
from ..ops import radix
from ..ops.packed import PackedQFloat, digit_bits
from ..runtime import native


def float_matrix_to_qfloat_arrays(M, qfloat_len, qfloat_ints, qfloat_base, out=None):
    """Float matrix (..., n, n) -> ((..., n*n, len) int64 digits, (..., n*n)
    int64 signs), on the host (reference qfloat_matrix_inversion.py:222-236),
    written into ``out`` when it is given.

    An integer part wider than ``ints`` digits keeps its low digits, and
    the sign of 0.0 is +1.
    """
    M = np.asarray(M, dtype=np.float64)
    flat = M.reshape(M.shape[:-2] + (-1,))
    return radix.float_to_digits_and_sign(flat, qfloat_len, qfloat_ints, qfloat_base, out=out)


def qfloat_arrays_to_qfloat_matrix(qfloat_arrays, qfloat_signs, qfloat_ints, qfloat_base,
                                   backend="limb"):
    """(..., n*n, len) digit and (..., n*n) sign tensors -> n x n 2D list of
    QFloat cells (reference qfloat_matrix_inversion.py:239-262): a
    :class:`QFloat` of the digits for ``backend="limb"``, a
    :class:`PackedQFloat` packed by ``from_digits`` for "packed"."""
    n = int(np.sqrt(qfloat_arrays.shape[-2]))

    def cell(index):
        digits, sign = qfloat_arrays[..., index, :], qfloat_signs[..., index]
        if backend == "packed":
            return PackedQFloat.from_digits(digits, qfloat_ints, qfloat_base, sign)
        return QFloat(digits, qfloat_ints, qfloat_base, True, sign)

    return [[cell(i * n + j) for j in range(n)] for i in range(n)]


def qfloat_matrix_to_arrays_and_signs(M, qfloat_len, qfloat_ints, qfloat_base,
                                      batch_shape=None, device=None):
    """QFloat 2D-list matrix -> (..., n*n, len+1) int32 digits with the sign
    appended (reference qfloat_matrix_inversion.py:286-309).

    The reference's cell encoding: a ``SignedBinary`` cell writes its signed
    value at digit ``ints-1`` and in the sign slot, a ``Zero`` cell all
    zeros, sign included.  ``batch_shape`` and ``device`` default to those
    of the first QFloat cell; a matrix without one (L at n=1) needs them.
    """
    if batch_shape is None:
        like = next((c for row in M for c in row if isinstance(c, QFloatBase)), None)
        if like is None:
            raise ValueError("the matrix has no QFloat cell: pass batch_shape and device")
        batch_shape, device = like.bshape, like.device
    cells = []
    for row in M:
        for cell in row:
            out = torch.zeros(tuple(batch_shape) + (qfloat_len + 1,), dtype=torch.int32,
                              device=device)
            if isinstance(cell, QFloatBase):
                out[..., :qfloat_len] = cell.to_digits()
                out[..., qfloat_len] = torch.as_tensor(cell.sign, device=device)
            elif isinstance(cell, SignedBinary):
                v = torch.as_tensor(cell.value, device=device)
                out[..., qfloat_ints - 1] = v
                out[..., qfloat_len] = v
            elif not isinstance(cell, Zero):
                raise TypeError(f"unexpected cell type {type(cell).__name__}")
            cells.append(out)
    return torch.stack(cells, dim=-2)


def qfloat_and_signs_arrays_to_float_matrix(qfloat_arrays, qfloat_ints, qfloat_base):
    """(..., n*n, len+1) output arrays -> float matrix (..., n, n), on the
    host (reference qfloat_matrix_inversion.py:265-283)."""
    arr = np.asarray(qfloat_arrays)
    n = int(np.sqrt(arr.shape[-2]))
    if native.routed(arr.size // arr.shape[-1]):
        # the device's (..., n*n, len+1) int32 layout is the library's own
        values = native.dequantize_digits(arr, arr.shape[-1] - 1, qfloat_ints, qfloat_base)
    else:
        values = radix.digits_and_sign_to_float(arr[..., :-1], arr[..., -1], qfloat_ints,
                                                qfloat_base)
    return values.reshape(values.shape[:-1] + (n, n))


def float_matrix_to_mags_and_signs(M, qfloat_len, qfloat_ints, qfloat_base, out=None):
    """Float matrix (..., n, n) -> ((..., n*n) int64 magnitudes, int64 signs),
    written into ``out`` when it is given.

    An integer part wider than ``ints`` digits keeps its low digits, and
    the sign of 0.0 is +1.
    """
    bits = digit_bits(qfloat_base)
    M = np.asarray(M, dtype=np.float64)
    flat = M.reshape(M.shape[:-2] + (-1,))
    if native.routed(flat.size):
        return native.quantize_packed(flat, qfloat_len, qfloat_ints, qfloat_base, *(out or ()))
    return radix.into(out, radix.float_to_mags_and_sign(flat, qfloat_len, qfloat_ints, bits))


def mags_and_signs_to_float_matrix(mags, signs, qfloat_len, qfloat_ints, qfloat_base):
    """Packed output -> float matrix (..., n, n) (host side), at any base."""
    mags = np.asarray(mags)
    signs = np.asarray(signs)
    n = int(np.sqrt(mags.shape[-1]))
    if native.routed(mags.size):
        values = native.dequantize_packed(mags, signs, qfloat_len, qfloat_ints, qfloat_base)
    else:
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
