"""Circuit entry points: the full inverse with digit or packed I/O, with or
without overflow flags, and the partial pivot/L/U circuits.

Port of ``matrix_inversion_tpu/models/inverse.py:32-126,161-365``.  On the
packed backend two paths give bit-identical results: "fused" runs the
whole inversion as one CUDA kernel (ops/fused_inverse.py, any n; "auto"
takes it up to n = 12, ``FUSED_MAX_N``); the
op-by-op path (``models.qfloat_lu.qfloat_matrix_inverse_op_by_op``) runs
the circuit as eager PyTorch ops on int64 tensors, at any n, its divisions
on the card through the division kernels K2/K3 and its untracked base-2
multiplies through K4 (ops/long_division.py).  The JAX lowerings "unroll",
"vec" and "scan" all map to the op-by-op path: "vec" and "scan" exist in
the JAX package only to cap XLA compile time, and give the same bits as
"unroll" there.  Digit I/O on the packed backend packs the digits into
magnitudes on the device, runs the packed-I/O circuit and unpacks.  Any
other backend is the limb backend, any base: the circuit runs op by op on
:class:`~..core.qfloat.QFloat` digit arrays (the JAX package's object
path), its long divisions in K6 and its carry chains in K7 on the card
(ops/limb_kernels.py).
"""

from __future__ import annotations

import functools

import torch

from ..ops.fused_inverse import FUSED_MAX_N, fused_matrix_inverse
from ..ops.packed import digit_bits, digits_to_mags, mags_to_digits
from ..utils import profiling
from .marshal import qfloat_arrays_to_qfloat_matrix, qfloat_matrix_to_arrays_and_signs
from .qfloat_lu import (
    qfloat_lu_decomposition,
    qfloat_matrix_inverse_cells,
    qfloat_matrix_inverse_op_by_op,
    qfloat_pivot_matrix,
)


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


def _packed_circuit(mags, n, lowering, tensorize):
    """The packed-I/O circuit that ``lowering`` resolves to: K1, or the
    op-by-op path with ``tensorize`` grouping its multiplies and
    reciprocals (the same bits)."""
    if mags.shape[-1] != n * n:
        raise ValueError(f"mags must have shape (..., {n * n})")
    if _resolve_lowering(lowering, n, mags.device) == "fused":
        return fused_matrix_inverse
    return functools.partial(qfloat_matrix_inverse_op_by_op, tensorize=tensorize)


def qfloat_matrix_inverse_packed_io(mags, signs, n, qfloat_len, qfloat_ints,
                                    qfloat_base, true_division, tensorize=False,
                                    vectorize_rows=None, lowering=None):
    """Full inverse with packed I/O: ``(..., n*n)`` int64 magnitudes and
    signs in, the same out.  The arguments are the JAX package's
    (``matrix_inversion_tpu/models/inverse.py:192-203``); ``vectorize_rows``
    only changes the size of JAX's trace and is taken and ignored here."""
    fn = _packed_circuit(mags, n, lowering, tensorize)
    return fn(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division)


def qfloat_matrix_inverse_with_overflow(mags, signs, n, qfloat_len, qfloat_ints,
                                        qfloat_base, true_division, tensorize=False,
                                        lowering=None):
    """Packed-I/O inverse that also reports a per-matrix overflow flag.

    Returns ``(mags, signs, flag)``: ``flag`` is int32 of the batch shape,
    the OR of every digit dropped past the top of a window inside the
    inversion (the reference's open TODO, its qfloat.py:255-257), so that
    callers can reject saturated inverses.  Magnitudes and signs equal the
    untracked inverse's.  "fused" runs the tracked kernel, the op-by-op
    path the circuit under ``track_overflow()``.
    """
    fn = _packed_circuit(mags, n, lowering, tensorize)
    return fn(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division,
              track=True)


def _digit_inputs(qfloat_arrays, qfloat_signs, n, qfloat_len):
    """The digit and sign tensors of a digit-I/O entry point, checked:
    ``(..., n*n, len)`` digits and ``(..., n*n)`` signs, torch tensors on
    one device, which is where the circuit runs; the signs come back
    int64.  Host arrays are refused rather than run on the CPU."""
    digits, signs = qfloat_arrays, qfloat_signs
    if not (isinstance(digits, torch.Tensor) and isinstance(signs, torch.Tensor)):
        raise TypeError(
            f"digits and signs must be torch tensors on the device to run on, got "
            f"{type(digits).__name__} and {type(signs).__name__}: move host arrays there "
            "first (torch.from_numpy(a).to('cuda'))"
        )
    if digits.device != signs.device:
        raise ValueError(f"digits on {digits.device} and signs on {signs.device}: "
                         "put both on one device")
    signs = signs.to(torch.int64)
    if digits.shape[-2:] != (n * n, qfloat_len) or signs.shape != digits.shape[:-1]:
        raise ValueError(
            f"expected (..., {n * n}, {qfloat_len}) digits and (..., {n * n}) signs, "
            f"got {tuple(digits.shape)} and {tuple(signs.shape)}"
        )
    return digits, signs


def check_lowering(backend, lowering):
    """Raise the JAX package's ``ValueError`` for a lowering that only the
    packed backend has (``matrix_inversion_tpu/models/inverse.py:51-60``)."""
    if backend != "packed" and lowering in ("scan", "vec", "fused"):
        raise ValueError(
            f"lowering='{lowering}' requires the packed backend (base=2^k "
            f"encoding that fits int64); backend='{backend}' only supports "
            "the 'unroll' lowering. See README 'Lowerings and bases'."
        )


def qfloat_matrix_inverse(qfloat_arrays, qfloat_signs, n, qfloat_len, qfloat_ints,
                          qfloat_base, true_division, tensorize=False, backend="limb",
                          lowering=None):
    """Full inverse with digit I/O (reference qfloat_matrix_inversion.py:672-720):
    ``(..., n*n, len)`` digits and ``(..., n*n)`` signs in, ``(..., n*n,
    len+1)`` int32 digits with the sign appended out.

    ``backend="packed"``: the digits are packed into int64 magnitudes on
    their device, the packed-I/O circuit runs
    (:func:`qfloat_matrix_inverse_packed_io`, which takes ``lowering``: K1
    for CUDA tensors with n <= 12 under "auto"), and the output is unpacked
    into a preallocated int32 tensor.  Every output cell of the inverse is
    a QFloat, so this gives the bits of the JAX package's object path too.
    Any other ``backend`` runs that object path on limb cells, any base:
    the circuit op by op on :class:`~..core.qfloat.QFloat` digit arrays,
    with ``tensorize`` grouping its multiplies and reciprocals; it has only
    the "unroll" lowering, and "scan", "vec" or "fused" raise as in the JAX
    package.
    """
    check_lowering(backend, lowering)
    digits, signs = _digit_inputs(qfloat_arrays, qfloat_signs, n, qfloat_len)
    if backend != "packed":
        M = qfloat_arrays_to_qfloat_matrix(digits, signs, qfloat_ints, qfloat_base, backend)
        Minv = qfloat_matrix_inverse_cells(M, qfloat_len, qfloat_ints, true_division, tensorize)
        return qfloat_matrix_to_arrays_and_signs(Minv, qfloat_len, qfloat_ints, qfloat_base)
    with profiling.span("digits.pack"):
        mags = digits_to_mags(digits, digit_bits(qfloat_base))
    mags, out_signs = qfloat_matrix_inverse_packed_io(
        mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division, lowering=lowering,
    )
    with profiling.span("digits.unpack"):
        return digit_output(mags, out_signs, qfloat_len, qfloat_base)


def digit_output(mags, signs, qfloat_len, qfloat_base):
    """``(..., n*n)`` magnitudes and signs -> ``(..., n*n, len+1)`` int32
    digits with the sign appended, as the packed path of
    ``matrix_inversion_tpu/models/inverse.py:98-106`` gives them: on a card
    one launch of the unpack kernel, which writes every column."""
    return mags_to_digits(mags, qfloat_len, digit_bits(qfloat_base), signs=signs)


def _digit_matrix(qfloat_arrays, qfloat_signs, params, backend):
    """The QFloat cells of a partial circuit's checked digit input, and its
    signs."""
    n, qfloat_len, qfloat_ints, qfloat_base, *_ = params
    digits, signs = _digit_inputs(qfloat_arrays, qfloat_signs, n, qfloat_len)
    return qfloat_arrays_to_qfloat_matrix(digits, signs, qfloat_ints, qfloat_base, backend), signs


def qfloat_pivot(qfloat_arrays, qfloat_signs, params, backend="limb"):
    """Pivot-only partial circuit (reference qfloat_matrix_inversion.py:592-609):
    the ``(..., n, n)`` int32 permutation.  ``params`` is
    ``QFloatParams.as_list()``'s list; comparisons only, no kernel."""
    return qfloat_pivot_matrix(_digit_matrix(qfloat_arrays, qfloat_signs, params, backend)[0])


def _lu_factor(qfloat_arrays, qfloat_signs, params, backend, which):
    n, qfloat_len, qfloat_ints, qfloat_base, true_division, *_ = params
    M, signs = _digit_matrix(qfloat_arrays, qfloat_signs, params, backend)
    factor = qfloat_lu_decomposition(M, qfloat_len, qfloat_ints, true_division)[which]
    # L at n=1 is one SignedBinary cell: the batch shape comes from the input
    return qfloat_matrix_to_arrays_and_signs(factor, qfloat_len, qfloat_ints, qfloat_base,
                                             batch_shape=signs.shape[:-1], device=signs.device)


def qfloat_lu_L(qfloat_arrays, qfloat_signs, params, backend="limb"):
    """PLU partial circuit returning L as ``(..., n*n, len+1)`` int32 digits
    (reference qfloat_matrix_inversion.py:612-639), op by op on the inputs'
    device: on the packed backend its divisions and multiplies go where
    ``ops.packed`` routes them (K2 and K4 on the card), on the limb backend
    its divisions and carry chains where ``ops.limbs`` does (K6 and K7).  The diagonal's ``SignedBinary(1)`` and the
    upper ``Zero`` cells keep the reference's encoding."""
    return _lu_factor(qfloat_arrays, qfloat_signs, params, backend, 1)


def qfloat_lu_U(qfloat_arrays, qfloat_signs, params, backend="limb"):
    """PLU partial circuit returning U (reference
    qfloat_matrix_inversion.py:642-669), as :func:`qfloat_lu_L`."""
    return _lu_factor(qfloat_arrays, qfloat_signs, params, backend, 2)
