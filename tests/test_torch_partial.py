"""Port vs JAX package: the partial pivot/L/U circuits and the float oracle.

``qfloat_pivot``, ``qfloat_lu_L`` and ``qfloat_lu_U`` with
``backend="packed"`` are held exactly (int32 arrays equal) to the JAX
package's on the same digit inputs; the L and U outputs keep the
reference's encoding of ``SignedBinary`` and ``Zero`` cells.
``models/lu_float.py`` is held to the JAX package's copy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import inverse as jax_inverse
from matrix_inversion_tpu.models import lu_float as jax_lu_float

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models import lu_float, marshal, qfloat_lu

torch.set_num_threads(2)

CASES = [("low", 3), ("medium+", 3), ("high", 4)]
# absolute tolerance of L and U against the float oracle: Low keeps 14
# fraction bits and multiplies by a rounded reciprocal
ORACLE_ATOL = {"low": 0.5, "medium+": 1e-2, "high": 1e-2}


def digits_of(p, M):
    d, s = marshal.float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    return torch.from_numpy(d), torch.from_numpy(s)


def jax_params(name, n):
    return mi.PRESETS[name].replace(n=n).as_list()


def test_lu_float_matches_jax():
    rng = np.random.RandomState(0)
    for n in (2, 3, 5):
        M = rng.randn(n, n) * 100
        np.testing.assert_array_equal(lu_float.pivot_matrix(M), jax_lu_float.pivot_matrix(M))
        got, ref = lu_float.lu_decomposition(M), jax_lu_float.lu_decomposition(M)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        for g, r in zip(lu_float.lu_inverse(*got, debug=True),
                        jax_lu_float.lu_inverse(*ref, debug=True)):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(lu_float.matrix_inverse(M), jax_lu_float.matrix_inverse(M))
        np.testing.assert_allclose(lu_float.matrix_inverse(M), np.linalg.inv(M), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("name", mi.PRESETS)
def test_as_list_matches_jax(name):
    p = mt.PRESETS[name].replace(n=5)
    assert p.as_list() == mi.PRESETS[name].replace(n=5).as_list()
    assert p.as_list()[5] is False


@pytest.mark.parametrize("name,n", CASES)
def test_pivot_matches_jax_and_the_oracle(name, n):
    """Five matrices as one batch and each alone, against JAX and against
    ``lu_float.pivot_matrix``."""
    p = mt.PRESETS[name].replace(n=n)
    M = np.random.RandomState(n + len(name)).randn(5, n, n) * 100
    M[1, :, 0] = [(-1) ** i * 7.0 for i in range(n)]  # ties in a column: the first wins
    d, s = digits_of(p, M)
    got = mt.qfloat_pivot(d, s, p.as_list(), "packed")
    assert got.dtype == torch.int32 and got.shape == (5, n, n)
    ref = np.asarray(jax_inverse.qfloat_pivot(jnp.asarray(d.numpy()), jnp.asarray(s.numpy()),
                                              jax_params(name, n), "packed"))
    np.testing.assert_array_equal(got.numpy(), ref)
    for b in range(5):
        one = mt.qfloat_pivot(d[b], s[b], p.as_list(), backend="packed")
        assert one.shape == (n, n)
        np.testing.assert_array_equal(one.numpy(), got[b].numpy())
        np.testing.assert_array_equal(one.numpy(), lu_float.pivot_matrix(M[b]).astype(int))
    # the reference's default backend, limb, gives the same permutation
    assert torch.equal(mt.qfloat_pivot(d, s, p.as_list()), got)


@pytest.mark.parametrize("name,n", CASES)
def test_lu_factors_match_jax(name, n):
    p = mt.PRESETS[name].replace(n=n)
    M = np.random.RandomState(10 + n).randn(4, n, n) * 100
    d, s = digits_of(p, M)
    jd, js = jnp.asarray(d.numpy()), jnp.asarray(s.numpy())
    L_len = p.qfloat_len + 1
    for fn, jax_fn in ((mt.qfloat_lu_L, jax_inverse.qfloat_lu_L),
                       (mt.qfloat_lu_U, jax_inverse.qfloat_lu_U)):
        got = fn(d, s, p.as_list(), "packed")
        assert got.dtype == torch.int32 and got.shape == (4, n * n, L_len)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_fn(jd, js, jax_params(name, n), "packed")))
    L = mt.qfloat_lu_L(d, s, p.as_list(), "packed").numpy().reshape(4, n, n, L_len)
    U = mt.qfloat_lu_U(d, s, p.as_list(), "packed").numpy().reshape(4, n, n, L_len)
    # L's diagonal is SignedBinary(1): 1 at digit ints-1 and in the sign
    # slot; above it, and below U's diagonal, Zero cells: all zeros
    unit = np.zeros(L_len, np.int32)
    unit[[p.qfloat_ints - 1, -1]] = 1
    for i in range(n):
        np.testing.assert_array_equal(L[:, i, i], np.broadcast_to(unit, (4, L_len)))
        for j in range(i + 1, n):
            np.testing.assert_array_equal(L[:, i, j], 0)
            np.testing.assert_array_equal(U[:, j, i], 0)
    for b in range(4):
        _, L_, U_ = lu_float.lu_decomposition(M[b])
        Lf = marshal.qfloat_and_signs_arrays_to_float_matrix(L[b].reshape(n * n, L_len),
                                                             p.qfloat_ints, 2)
        Uf = marshal.qfloat_and_signs_arrays_to_float_matrix(U[b].reshape(n * n, L_len),
                                                             p.qfloat_ints, 2)
        np.testing.assert_allclose(Lf, L_, atol=ORACLE_ATOL[name])
        np.testing.assert_allclose(Uf, U_, atol=ORACLE_ATOL[name])


@pytest.mark.parametrize("name", ["low", "high"])
def test_partial_circuits_one_by_one_match_jax(name):
    """n=1: the pivot is [[1]], L the single cell ``SignedBinary(1)`` and U
    the input.  JAX's L has no batch dimensions (its one cell is a Python
    scalar); the port's keeps the input's, each matrix equal to JAX's."""
    p = mt.PRESETS[name].replace(n=1)
    M = np.array([[[3.5]], [[-2.25]], [[0.0]]])
    d, s = digits_of(p, M)
    jd, js = jnp.asarray(d.numpy()), jnp.asarray(s.numpy())
    L_len = p.qfloat_len + 1
    for fn, jax_fn, shape in ((mt.qfloat_pivot, jax_inverse.qfloat_pivot, (3, 1, 1)),
                              (mt.qfloat_lu_L, jax_inverse.qfloat_lu_L, (3, 1, L_len)),
                              (mt.qfloat_lu_U, jax_inverse.qfloat_lu_U, (3, 1, L_len))):
        got = fn(d, s, p.as_list(), "packed")
        assert got.dtype == torch.int32 and got.shape == shape, fn.__name__
        ref = np.asarray(jax_fn(jd, js, jax_params(name, 1), "packed"))
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(ref, shape))
    L = mt.qfloat_lu_L(d[0], s[0], p.as_list(), "packed")
    assert L.shape == (1, L_len) and L[0, p.qfloat_ints - 1] == 1 and L[0, -1] == 1


def test_lu_decomposition_matches_the_inverse_circuit():
    """``qfloat_lu_decomposition`` gives the cells from which the whole
    inverse is built."""
    p = mt.HIGH.replace(n=4)
    M = np.random.RandomState(3).randn(6, 4, 4) * 100
    d, s = digits_of(p, M)
    cells = marshal.qfloat_arrays_to_qfloat_matrix(d, s, p.qfloat_ints, 2, backend="packed")
    P, L, U = qfloat_lu.qfloat_lu_decomposition(cells, 40, 20, True)
    inv = qfloat_lu.qfloat_lu_inverse(P, L, U, 40, 20, True)
    got = marshal.qfloat_matrix_to_arrays_and_signs(inv, 40, 20, 2)
    want = mt.qfloat_matrix_inverse(d, s, 4, 40, 20, 2, True, backend="packed")
    assert torch.equal(got, want)
    piv = qfloat_lu.qfloat_pivot_matrix(cells)
    assert [[int(c.value[0]) for c in row] for row in qfloat_lu.binary_list_matrix(piv)] == \
        piv[0].tolist()
