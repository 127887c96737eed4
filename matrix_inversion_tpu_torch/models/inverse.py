"""Packed-I/O circuit entry points, untracked and overflow-tracked.

Port of ``matrix_inversion_tpu/models/inverse.py:161-325``.  Two paths
with bit-identical results: "fused" runs the whole inversion as one CUDA
kernel (ops/fused_inverse.py, n <= 12); the op-by-op path
(``models.qfloat_lu.qfloat_matrix_inverse_op_by_op``) runs the circuit as
eager PyTorch ops on int64 tensors, at any n, its divisions on the card
through the division kernels K2/K3 and its untracked base-2 multiplies
through K4 (ops/long_division.py).  The JAX
lowerings "unroll", "vec" and "scan" all map to the op-by-op path: "vec"
and "scan" exist in the JAX package only to cap XLA compile time, and
give the same bits as "unroll" there.  The digit-I/O entry point and the
partial circuits are ROADMAP queue 1, items 7 and 8.
"""

from __future__ import annotations

from ..ops.fused_inverse import FUSED_MAX_N, fused_matrix_inverse
from .qfloat_lu import qfloat_matrix_inverse_op_by_op


def _resolve_lowering(lowering, n, device):
    """"fused" or "op_by_op".  ``auto`` picks the fused kernel for CUDA
    tensors with n <= 12 and the op-by-op path otherwise; "unroll", "vec"
    and "scan" are the op-by-op path."""
    if lowering in (None, "auto"):
        if device.type == "cuda" and n <= FUSED_MAX_N:
            return "fused"
        return "op_by_op"
    if lowering in ("unroll", "vec", "scan"):
        return "op_by_op"
    if lowering != "fused":
        raise ValueError(f"unknown lowering {lowering!r}: expected auto|unroll|vec|scan|fused")
    return lowering


def qfloat_matrix_inverse_packed_io(mags, signs, n, qfloat_len, qfloat_ints,
                                    qfloat_base, true_division, lowering=None):
    """Full inverse with packed I/O: ``(..., n*n)`` int64 magnitudes and
    signs in, the same out."""
    if mags.shape[-1] != n * n:
        raise ValueError(f"mags must have shape (..., {n * n})")
    style = _resolve_lowering(lowering, n, mags.device)
    fn = fused_matrix_inverse if style == "fused" else qfloat_matrix_inverse_op_by_op
    return fn(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division)


def qfloat_matrix_inverse_with_overflow(mags, signs, n, qfloat_len, qfloat_ints,
                                        qfloat_base, true_division, lowering=None):
    """Packed-I/O inverse that also reports a per-matrix overflow flag.

    Returns ``(mags, signs, flag)``: ``flag`` is int32 of the batch shape,
    the OR of every digit dropped past the top of a window inside the
    inversion (the reference's open TODO, its qfloat.py:255-257), so that
    callers can reject saturated inverses.  Magnitudes and signs equal the
    untracked inverse's.  "fused" runs the tracked kernel, the op-by-op
    path the circuit under ``track_overflow()``.
    """
    if mags.shape[-1] != n * n:
        raise ValueError(f"mags must have shape (..., {n * n})")
    style = _resolve_lowering(lowering, n, mags.device)
    fn = fused_matrix_inverse if style == "fused" else qfloat_matrix_inverse_op_by_op
    return fn(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division,
              track=True)
