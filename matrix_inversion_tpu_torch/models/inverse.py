"""Packed-I/O circuit entry points, untracked and overflow-tracked.

Port of ``matrix_inversion_tpu/models/inverse.py:161-325``.  Two lowerings
with bit-identical results: "fused" runs the whole inversion as one CUDA
kernel (ops/fused_inverse.py), "unroll" runs the circuit op by op on int64
tensors.  The digit-I/O entry point and the partial circuits are ROADMAP
queue 1, items 7 and 8.
"""

from __future__ import annotations

from ..ops.fused_inverse import (
    FUSED_MAX_N,
    fused_matrix_inverse,
    fused_matrix_inverse_reference,
)


def _resolve_lowering(lowering, n, device):
    """``auto`` picks the fused kernel for CUDA tensors with n <= 12 and the
    eager circuit otherwise."""
    if lowering in (None, "auto"):
        if device.type == "cuda" and n <= FUSED_MAX_N:
            return "fused"
        return "unroll"
    if lowering in ("vec", "scan"):
        raise ValueError(
            f"lowering {lowering!r} is not ported yet (ROADMAP queue 1, item 11): "
            "expected auto|unroll|fused"
        )
    if lowering not in ("unroll", "fused"):
        raise ValueError(f"unknown lowering {lowering!r}: expected auto|unroll|fused")
    return lowering


def qfloat_matrix_inverse_packed_io(mags, signs, n, qfloat_len, qfloat_ints,
                                    qfloat_base, true_division, lowering=None):
    """Full inverse with packed I/O: ``(..., n*n)`` int64 magnitudes and
    signs in, the same out."""
    if mags.shape[-1] != n * n:
        raise ValueError(f"mags must have shape (..., {n * n})")
    style = _resolve_lowering(lowering, n, mags.device)
    fn = fused_matrix_inverse if style == "fused" else fused_matrix_inverse_reference
    return fn(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division)


def qfloat_matrix_inverse_with_overflow(mags, signs, n, qfloat_len, qfloat_ints,
                                        qfloat_base, true_division, lowering=None):
    """Packed-I/O inverse that also reports a per-matrix overflow flag.

    Returns ``(mags, signs, flag)``: ``flag`` is int32 of the batch shape,
    the OR of every digit dropped past the top of a window inside the
    inversion (the reference's open TODO, its qfloat.py:255-257), so that
    callers can reject saturated inverses.  Magnitudes and signs equal the
    untracked inverse's.  "fused" runs the tracked kernel, "unroll" the
    circuit under ``track_overflow()``.
    """
    if mags.shape[-1] != n * n:
        raise ValueError(f"mags must have shape (..., {n * n})")
    style = _resolve_lowering(lowering, n, mags.device)
    fn = fused_matrix_inverse if style == "fused" else fused_matrix_inverse_reference
    return fn(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division,
              track=True)
