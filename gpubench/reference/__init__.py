"""The benchmark's plain reference: QFloat inversion in eager PyTorch.

``circuit`` holds the inverse on packed cells and ``marshal`` the encodings
around it.  :func:`expected` gives what a configuration's inverse of a float
batch is, in any of the program's I/O forms.  Nothing here imports the
program under test.
"""

from __future__ import annotations

import torch

from . import circuit, marshal

#: matrices worked out at a time: sized for the card's memory, not for any traffic
BLOCK = 262144


def bits_of(base):
    if base < 2 or base & (base - 1):
        raise ValueError(f"the packed reference takes a power-of-two base, not {base}")
    return base.bit_length() - 1


def packed_inverse(floats, fmt, block=None, track=False):
    """``(B, n, n)`` float64 tensor -> the inverse's ``(B, n*n)`` int64
    magnitudes and signs in ``fmt`` (a dict with ``n``, ``qfloat_len``,
    ``qfloat_ints``, ``qfloat_base``, ``true_division``), on the floats'
    device, ``block`` (default :data:`BLOCK`) matrices at a time; ``track``
    adds the ``(B,)`` int32 overflow flags."""
    n, length, ints = fmt["n"], fmt["qfloat_len"], fmt["qfloat_ints"]
    bits = bits_of(fmt["qfloat_base"])
    block = block or BLOCK
    parts = []
    for start in range(0, floats.shape[0], block):
        m, s = marshal.quantize(floats[start:start + block], length, ints, bits)
        parts.append(circuit.inverse(m, s, n, length, ints, bits, fmt["true_division"], track))
    return tuple(torch.cat(p) for p in zip(*parts))


def expected(floats, fmt, io, block=None, cells_fmt=None, track=False):
    """The inverse of ``floats`` as the program hands it out under ``io``:
    ``"packed"`` (magnitudes, signs; with ``track`` also the ``(B,)`` int32
    overflow flags), ``"digits"`` (int32 digits with the sign column) or
    ``"floats"`` (float64 ``(B, n, n)``).  ``cells_fmt`` (default ``fmt``) is
    the format the answer is written in: a result computed in a narrower
    ``fmt`` is widened exactly into it."""
    if track and io != "packed":
        raise ValueError("overflow flags come with packed I/O only")
    out_fmt = cells_fmt or fmt
    bits = bits_of(fmt["qfloat_base"])
    mags, signs, *flags = packed_inverse(floats, fmt, block, track)
    mags = marshal.widen(mags, (fmt["qfloat_len"], fmt["qfloat_ints"]),
                         (out_fmt["qfloat_len"], out_fmt["qfloat_ints"]), bits)
    if io == "packed":
        return (mags, signs, *flags)
    if io == "digits":
        return marshal.digit_output(mags, signs, out_fmt["qfloat_len"], bits)
    if io == "floats":
        return marshal.dequantize(mags, signs, out_fmt["qfloat_len"], out_fmt["qfloat_ints"],
                                  bits, fmt["n"])
    raise ValueError(f"unknown io {io!r}")
