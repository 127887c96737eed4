"""QFloat pivoting, LU decomposition, LU inverse and the 2x2 closed form.

Port of ``matrix_inversion_tpu/models/qfloat_lu.py:42-375``.  Matrices
are n x n Python lists whose cells are ``Zero``, ``SignedBinary`` or a
QFloat type; the n-loops unroll while the circuit is built.  The pivot and
argmax arithmetic uses operators only (no dtype casts, no indexed
updates), so the same code runs eagerly on digit arrays
(``core.qfloat.QFloat``, the limb backend), on int64 magnitudes
(``ops.packed.PackedQFloat``; :func:`qfloat_matrix_inverse_op_by_op`, the
op-by-op path) and on the integer symbols of the CUDA kernel emitter
(``ops.emit``).  ``tensorize=True`` groups the independent multiplies of a
dot product, and the reciprocals of U's diagonal, into one op each on the
limb backend, as the JAX package does; the packed cells multiply one by
one under it (the JAX package's grouped packed dot products give the same
values).
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from ..core.qfloat import (
    QFloatBase,
    SignedBinary,
    Zero,
    qf_from_mul,
    qf_multi_from_mul,
    qf_multi_invert,
)
from ..ops.packed import track_overflow
from .marshal import mags_and_signs_to_qfloat_matrix, qfloat_matrix_to_mags_and_signs


def matrix_column(M, j):
    return [row[j] for row in M]


def transpose_2D_list(list2D):
    return [list(row) for row in zip(*list2D)]


def map_2D_list(list2D, function):
    return [[function(x) for x in row] for row in list2D]


def binary_list_matrix(M):
    """Wrap a (..., n, n) 0/1 integer tensor as SignedBinary cells."""
    n = M.shape[-1]
    return [[SignedBinary(M[..., i, j]) for j in range(n)] for i in range(n)]


def zero_list_matrix(n):
    return [[Zero() for _ in range(n)] for _ in range(n)]


def qfloat_list_dot_product(list1, list2, tensorize=False):
    """Sequential multiply-accumulate (reference qfloat_matrix_inversion.py:183-205);
    with ``tensorize`` the multiplies first, grouped, then the adds in order."""
    if len(list1) != len(list2):
        raise ValueError("Lists should have the same length.")
    if tensorize:
        multiplications = qf_multi_from_mul(list1, list2, None, None)
        result = multiplications[0]
        for m in multiplications[1:]:
            result += m
        return result
    result = list1[0] * list2[0]
    for i in range(1, len(list1)):
        result += list1[i] * list2[i]
    return result


def qfloat_list_matrix_multiply(matrix1, matrix2):
    return [
        [
            qfloat_list_dot_product(matrix1[i], matrix_column(matrix2, j))
            for j in range(len(matrix2[0]))
        ]
        for i in range(len(matrix1))
    ]


def qfloat_argmax(indices, qfloats):
    """Index of the largest QFloat via a branchless max-scan.

    Bug-compatible with reference qfloat_matrix_inversion.py:317-328: only
    the magnitude of the running max is blended, not its sign.
    """
    max_qf = qfloats[0].copy()
    maxi = indices[0]
    for i in range(1, len(indices)):
        is_gt = qfloats[i] > max_qf
        max_qf.blend_from(qfloats[i], is_gt)
        maxi = is_gt * indices[i] + (1 - is_gt) * maxi
    return maxi


def qfloat_pivot_cells(M):
    """Pivot permutation as an n x n list of 0/1 integers, one per cell.

    Row j of the permutation becomes one-hot row ``r = argmax_i |M[i][j]|``
    (reference qfloat_matrix_inversion.py:331-369), with ``r`` per matrix
    of the batch: one-hot arithmetic, no branch.
    """
    assert len(M) == len(M[0])
    n = len(M)
    P = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for j in range(n - 1):
        r = qfloat_argmax(
            [i for i in range(j, n)], [abs(M[i][j]) for i in range(j, n)]
        )
        temp = [row[:] for row in P]
        # row j becomes row r
        for c in range(n):
            bsum = temp[j][c] * ((r == j) * 1)
            for i in range(j + 1, n):
                bsum = bsum + temp[i][c] * ((r == i) * 1)
            P[j][c] = bsum
        # row r becomes row j
        for jj in range(j + 1, n):
            e = (r == jj) * 1
            for c in range(n):
                P[jj][c] = (1 - e) * temp[jj][c] + e * temp[j][c]
    return P


def qfloat_pivot_matrix(M):
    """Pivot permutation as a (..., n, n) int32 tensor (reference
    qfloat_matrix_inversion.py:331-369, batched): the cells of
    :func:`qfloat_pivot_cells` stacked."""
    like = next(c for row in M for c in row if isinstance(c, QFloatBase))
    rows = [
        torch.stack([torch.broadcast_to(torch.as_tensor(c, device=like.device), like.bshape)
                     for c in row], dim=-1)
        for row in qfloat_pivot_cells(M)
    ]
    return torch.stack(rows, dim=-2).to(torch.int32)


def qfloat_pivot_binary(M):
    """The pivot permutation as an n x n list of ``SignedBinary`` cells, the
    form :func:`lu_from_pivot` takes."""
    return [[SignedBinary(c) for c in row] for row in qfloat_pivot_cells(M)]


def qfloat_lu_decomposition(M, qfloat_len, qfloat_ints, true_division=False, tensorize=False):
    """PM = LU on a QFloat 2D-list matrix; returns ``(P^T, L, U)`` with
    M = PLU (``matrix_inversion_tpu/models/qfloat_lu.py:228-231``)."""
    return lu_from_pivot(qfloat_pivot_binary(M), M, qfloat_len, qfloat_ints, true_division,
                         tensorize)


def lu_from_pivot(P, M, qfloat_len, qfloat_ints, true_division=False, tensorize=False):
    """Doolittle LU given a SignedBinary pivot matrix ``P``; returns
    ``(P^T, L, U)`` (reference qfloat_matrix_inversion.py:377-453)."""
    assert len(M) == len(M[0])
    n = len(M)

    L = zero_list_matrix(n)
    U = zero_list_matrix(n)

    PM = qfloat_list_matrix_multiply(P, M)

    for j in range(n):
        L[j][j] = SignedBinary(1)
        # u_{ij} = a_{ij} - sum_k u_{kj} l_{ik}
        for i in range(j + 1):
            if i > 0:
                s1 = qfloat_list_dot_product(
                    [U[k][j] for k in range(0, i)],
                    [L[i][k] for k in range(0, i)],
                    tensorize,
                )
                U[i][j] = PM[i][j] + s1.neg()
            else:
                U[i][j] = PM[i][j].copy()

        # l_{ij} = (a_{ij} - sum_k u_{kj} l_{ik}) / u_{jj}
        if not true_division:
            inv_Ujj = U[j][j].invert(1, qfloat_len, 0)
        for i in range(j + 1, n):
            if j > 0:
                s2 = qfloat_list_dot_product(
                    [U[k][j] for k in range(0, j)],
                    [L[i][k] for k in range(0, j)],
                    tensorize,
                )
                if true_division:
                    L[i][j] = (PM[i][j] + s2.neg()) / U[j][j]
                else:
                    L[i][j] = qf_from_mul(
                        (PM[i][j] + s2.neg()), inv_Ujj, qfloat_len, qfloat_ints
                    )
            else:
                if true_division:
                    L[i][j] = PM[i][j] / U[j][j]
                else:
                    L[i][j] = qf_from_mul(PM[i][j], inv_Ujj, qfloat_len, qfloat_ints)

    P = transpose_2D_list(P)
    return P, L, U


def qfloat_lu_inverse(P, L, U, qfloat_len, qfloat_ints, true_division=False, tensorize=False,
                      debug=False):
    """Inverse from the P, L, U decomposition (reference
    qfloat_matrix_inversion.py:461-518); with ``debug=True`` returns
    ``(Minv, Y, X)``, the substitutions' cell matrices beside it, as
    ``matrix_inversion_tpu/models/qfloat_lu.py:294-335`` does."""
    n = len(L)

    # Forward substitution: L * Y = P
    Y = zero_list_matrix(n)
    for i in range(n):
        # L diagonal is 1, no division needed
        Y[i][0] = P[i][0].copy()
        for j in range(1, n):
            Y[i][j] = P[i][j] - qfloat_list_dot_product(
                [L[j][k] for k in range(j)], [Y[i][k] for k in range(j)], tensorize
            )

    # Backward substitution: U * X = Y
    X = zero_list_matrix(n)
    if not true_division:
        if tensorize:
            Ujj_inv = qf_multi_invert([U[j][j] for j in range(n)], 1, qfloat_len, 0)
        else:
            Ujj_inv = [U[j][j].invert(1, qfloat_len, 0) for j in range(n)]
    for i in range(n - 1, -1, -1):
        if true_division:
            X[i][-1] = Y[i][-1] / U[-1][-1]
        else:
            X[i][-1] = qf_from_mul(Y[i][-1], Ujj_inv[-1], qfloat_len, qfloat_ints)
        for j in range(n - 2, -1, -1):
            temp = Y[i][j] - qfloat_list_dot_product(
                [U[j][k] for k in range(j + 1, n)],
                [X[i][k] for k in range(j + 1, n)],
                tensorize,
            )
            if true_division:
                X[i][j] = temp / U[j][j]
            else:
                X[i][j] = qf_from_mul(temp, Ujj_inv[j], qfloat_len, qfloat_ints)

    if debug:
        return transpose_2D_list(X), Y, X
    return transpose_2D_list(X)


def qfloat_inverse_2x2(qfloat_M, qfloat_len, qfloat_ints):
    """M_inv = adj(M) / det(M) with widened intermediate formats
    (reference qfloat_matrix_inversion.py:526-556)."""
    [a, b] = qfloat_M[0]
    [c, d] = qfloat_M[1]

    ad = qf_from_mul(a, d, 2 * qfloat_ints + 3, 2 * qfloat_ints)
    bc = qf_from_mul(b, c, 2 * qfloat_ints + 3, 2 * qfloat_ints)

    det = ad + bc.neg()
    det_inv = det.invert(1, qfloat_len, 0)

    mul = lambda x, y: qf_from_mul(x, y, qfloat_len, qfloat_ints)
    return [
        [mul(d, det_inv), mul(b, det_inv).neg()],
        [mul(c, det_inv).neg(), mul(a, det_inv)],
    ]


def qfloat_inverse_2x2_multi(qfloat_M, qfloat_len, qfloat_ints):
    """The closed form with its multiplies grouped (reference
    qfloat_matrix_inversion.py:558-584)."""
    [a, b] = qfloat_M[0]
    [c, d] = qfloat_M[1]

    [ad, bc] = qf_multi_from_mul([a, b], [d, c], 2 * qfloat_ints + 3, 2 * qfloat_ints)
    det = ad + bc.neg()
    det_inv = det.invert(1, qfloat_len, 0)
    [mula, mulb, mulc, muld] = qf_multi_from_mul(
        [a, b, c, d], [det_inv] * 4, qfloat_len, qfloat_ints
    )
    return [
        [muld, mulb.neg()],
        [mulc.neg(), mula],
    ]


def qfloat_matrix_inverse_cells(M, qfloat_len, qfloat_ints, true_division, tensorize=False):
    """The whole inverse circuit on an n x n list of QFloat cells.

    The op sequence of ``matrix_inversion_tpu/ops/fused_inverse.py:114-125``
    (of ``models/inverse.py:108-122`` with ``tensorize``): the closed form
    for n = 2; otherwise pivot cells, LU and substitution.
    """
    n = len(M)
    if n == 2:
        if tensorize:
            return qfloat_inverse_2x2_multi(M, qfloat_len, qfloat_ints)
        return qfloat_inverse_2x2(M, qfloat_len, qfloat_ints)
    Pb, Lm, Um = lu_from_pivot(qfloat_pivot_binary(M), M, qfloat_len, qfloat_ints,
                               true_division, tensorize)
    return qfloat_lu_inverse(Pb, Lm, Um, qfloat_len, qfloat_ints, true_division, tensorize)


def qfloat_matrix_inverse_op_by_op(mags, signs, n, qfloat_len, qfloat_ints,
                                   qfloat_base, true_division, track=False, tensorize=False):
    """The op-by-op path: the whole circuit run eagerly on int64
    :class:`~..ops.packed.PackedQFloat` cells, ``(..., n*n)`` magnitudes and
    signs in, the same out, on any device and at any n.

    Each division and multiply goes where ``ops.packed`` routes it: a CUDA
    tensor divides through the division kernels (K2, or K3 under
    ``set_division_impl("classic")``) and takes its untracked base-2
    multiplies through the windowed-multiply kernel K4; a CPU tensor, or
    any tensor inside ``plain_arithmetic()``, takes the plain versions.  ``track=True`` runs the circuit inside
    ``track_overflow()`` and also returns the combined flags, int32 of the
    batch shape.  ``tensorize`` groups the multiplies of a dot product
    and the reciprocals as the JAX package does: the same bits.
    """
    if mags.shape[-1] != n * n:
        raise ValueError(f"mags must have shape (..., {n * n})")
    with track_overflow() if track else nullcontext() as tracker:
        M = mags_and_signs_to_qfloat_matrix(mags, signs, qfloat_len, qfloat_ints, qfloat_base)
        Minv = qfloat_matrix_inverse_cells(M, qfloat_len, qfloat_ints, true_division, tensorize)
    out = qfloat_matrix_to_mags_and_signs(Minv, qfloat_len, qfloat_ints, qfloat_base)
    if track:
        return (*out, tracker.combined(mags.shape[:-1], device=mags.device))
    return out
