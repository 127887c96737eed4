"""Port vs JAX package past the fused kernel's n <= 12: the op-by-op path.

At n = 13 the JAX package's ``lowering="auto"`` runs its scanned lowering
(``models/qfloat_lu_scan.py``); the port runs the circuit op by op.  Both
get the same numpy inputs -- random x100 matrices with zero and sign-0
cells, out-of-range entries, a near-singular and an all-zero matrix -- and
must agree with tolerance 0 on magnitudes, signs and overflow flags.  On
the CPU every division goes through the division kernels' plain version;
the kernels themselves are held to it in tests/test_torch_division.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import inverse as jax_inverse
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.utils import profiling

torch.set_num_threads(2)

N, B = 13, 8
P = mt.LOW.replace(n=N)
ARGS = (N, P.qfloat_len, P.qfloat_ints, P.qfloat_base, P.true_division)


def _matrices(out_of_range=True):
    """Matrices 0-3 random x100, whose LU overflows LOW's 9 integer
    digits; 0 near-singular and 1 all zero.  Matrices 4-7 well conditioned
    (``randn*10 + 20*I``, as tests/test_lu_scan.py:95) and picked inside
    LOW's range at n = 13: no flag.  About a tenth of the cells are zero.
    ``out_of_range`` widens some entries of matrix 2 past 9 integer
    digits."""
    rng = np.random.RandomState(12)
    M = rng.randn(B, N, N) * 100
    M[rng.rand(B, N, N) < 0.1] = 0.0
    W = np.random.RandomState(13).randn(8, N, N) * 10 + 20 * np.eye(N)
    W[np.random.RandomState(1).rand(8, N, N) < 0.1] = 0.0
    M[4:] = W[[0, 1, 3, 4]]
    if out_of_range:
        M[2, 3, :4] *= 40
    M[0, 1] = M[0, 0] * (1 + 1e-12)
    M[1] = 0.0
    return M


@pytest.fixture(scope="module")
def inputs():
    mags, signs = float_matrix_to_mags_and_signs(_matrices(), *ARGS[1:4])
    signs[np.random.RandomState(14).rand(*signs.shape) < 0.08] = 0  # sign-0 cells
    assert (signs == 0).any()
    return mags, signs


@pytest.fixture(scope="module")
def port_untracked(inputs):
    mags, signs = map(torch.from_numpy, inputs)
    before = profiling.counters("launch.")
    out = mt.qfloat_matrix_inverse_packed_io(mags, signs, *ARGS)
    assert profiling.counters("launch.") == before
    return out


def test_auto_is_scan_in_jax():
    assert jax_inverse._resolve_lowering("auto", N, packed_ok=True) == "scan"


def test_op_by_op_matches_jax_scan(inputs, port_untracked):
    ref_m, ref_s = jax_inverse.qfloat_matrix_inverse_packed_io(
        *map(jnp.asarray, inputs), *ARGS, lowering="auto"
    )
    np.testing.assert_array_equal(port_untracked[0].numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(port_untracked[1].numpy(), np.asarray(ref_s))


def test_tracked_op_by_op_matches_jax_scan(inputs, port_untracked):
    mags, signs = map(torch.from_numpy, inputs)
    got = mt.qfloat_matrix_inverse_with_overflow(mags, signs, *ARGS)
    ref = jax_inverse.qfloat_matrix_inverse_with_overflow(
        *map(jnp.asarray, inputs), *ARGS, lowering="auto"
    )
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2].dtype == torch.int32
    assert got[2].tolist()[:2] == [1, 1] and not got[2].all()
    assert all(torch.equal(g, u) for g, u in zip(got[:2], port_untracked))


@pytest.mark.parametrize("lowering", ["unroll", "vec", "scan"])
def test_lowerings_are_the_op_by_op_path(inputs, port_untracked, lowering):
    mags, signs = map(torch.from_numpy, inputs)
    got = mt.qfloat_matrix_inverse_packed_io(mags, signs, *ARGS, lowering=lowering)
    assert all(torch.equal(g, r) for g, r in zip(got, port_untracked))


def test_batched_api_scan_matches_jax():
    """The whole API, quantize to dequantize.  No entry is out of range:
    there the JAX package's small-batch quantize route leaves magnitudes
    untidy (ROADMAP queue 3), and the port follows its native route."""
    M = _matrices(out_of_range=False)
    port = mt.BatchedMatrixInversion(P.replace(lowering="scan"), B, io="packed", device="cpu")
    ref = JaxBatched(mi.LOW.replace(n=N, lowering="scan"), B, backend="packed", io="packed")
    got = port.run(M)
    np.testing.assert_array_equal(got, ref.run(M))
    assert np.isfinite(got).all()
    assert np.max(np.abs(got[4:] - np.linalg.inv(M[4:]))) < 1e-2
    tracked = mt.BatchedMatrixInversion(P.replace(lowering="scan"), B, io="packed", device="cpu",
                                        track_overflow=True)
    got_t, flags = tracked.run(M)
    np.testing.assert_array_equal(got_t, got)
    ref_flags = mt.qfloat_matrix_inverse_with_overflow(*tracked.quantize(M), *ARGS)[2]
    np.testing.assert_array_equal(flags, ref_flags.numpy())
    assert flags.tolist()[:2] == [1, 1] and not flags[4:].any()
