"""Float LU-decomposition oracle: Doolittle pivot / LU / inverse on plain floats.

A numpy copy of ``matrix_inversion_tpu/models/lu_float.py`` (reference
qfloat_matrix_inversion.py:29-128), the comparison oracle of the tests for
the partial circuits.  It works on ONE matrix at a time, like the
reference, and is on no hot path.
"""

from __future__ import annotations

import numpy as np


def pivot_matrix(M: np.ndarray) -> np.ndarray:
    """Pivoting matrix for M (Doolittle), reference qfloat_matrix_inversion.py:29-47."""
    assert M.shape[0] == M.shape[1]
    n = M.shape[0]
    id_mat = np.eye(n)
    for j in range(n):
        row = max(range(j, n), key=lambda i: abs(M[i, j]))
        if j != row:
            id_mat[[j, row]] = id_mat[[row, j]]
    return id_mat


def lu_decomposition(M: np.ndarray):
    """PM = LU decomposition, reference qfloat_matrix_inversion.py:50-86."""
    assert M.shape[0] == M.shape[1]
    n = M.shape[0]
    L = np.zeros((n, n))
    U = np.zeros((n, n))
    P = pivot_matrix(M)
    PM = P @ M
    for j in range(n):
        L[j, j] = 1.0
        for i in range(j + 1):
            s1 = np.dot(U[0:i, j], L[i, 0:i])
            U[i, j] = PM[i, j] - s1
        for i in range(j + 1, n):
            s2 = np.dot(U[0:j, j], L[i, 0:j])
            L[i, j] = (PM[i, j] - s2) / U[j, j]
    return np.transpose(P), L, U


def lu_inverse(P, L, U, debug=False):
    """Inverse from P, L, U, reference qfloat_matrix_inversion.py:89-112."""
    n = L.shape[0]
    Y = np.zeros((n, n))
    for i in range(n):
        Y[i, 0] = P[i, 0] / L[0, 0]
        for j in range(1, n):
            Y[i, j] = P[i, j] - np.dot(L[j, :j], Y[i, :j])
    X = np.zeros((n, n))
    for i in range(n - 1, -1, -1):
        X[i, -1] = Y[i, -1] / U[-1, -1]
        for j in range(n - 2, -1, -1):
            X[i, j] = (Y[i, j] - np.dot(U[j, j + 1 :], X[i, j + 1 :])) / U[j, j]
    if not debug:
        return np.transpose(X)
    return np.transpose(X), Y, X


def matrix_inverse(M: np.ndarray) -> np.ndarray:
    P, L, U = lu_decomposition(M)
    return lu_inverse(P, L, U)
