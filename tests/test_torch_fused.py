"""Port vs JAX package: the whole inversion, kernel plain version and API.

The plain version of the fused kernel (the circuit run eagerly on int64
tensors) must equal the JAX package's unrolled packed-I/O circuit bit for
bit, as ``tests/test_fused.py`` holds the Pallas kernel body to it.  The
kernel itself runs only on the card; its emitted body is compiled for the
CPU in tests/test_torch_emit.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse_packed_io as jax_inverse
from matrix_inversion_tpu.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.ops import fused_inverse, packed
from matrix_inversion_tpu_torch.parallel import NamedSharding, P, make_mesh

torch.set_num_threads(2)

CONFIGS = [
    ("high", 2), ("high", 3), ("high", 4), ("high", 5),
    ("low", 4), ("medium", 3), ("medium+", 4),
]


def quantize(p, n, B, seed, singular=False):
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) * (1 if singular else 100)
    if singular:
        M[:, 2, :] = M[:, 0, :] + M[:, 1, :]  # rank-deficient
    mags, signs = float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    return np.asarray(mags), np.asarray(signs)


def check_plain_version(name, n, singular=False, **fmt):
    p = mi.PRESETS[name].replace(n=n, **fmt)
    mags, signs = quantize(p, n, 48, seed=n, singular=singular)
    args = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    ref_m, ref_s = jax_inverse(jnp.asarray(mags), jnp.asarray(signs), *args, lowering="unroll")
    got_m, got_s = fused_inverse.fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *args
    )
    assert got_m.dtype == torch.int64 and got_s.dtype == torch.int64
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    return mags, signs, args, got_m, got_s


@pytest.mark.parametrize("name,n", CONFIGS)
def test_plain_version_matches_jax_unroll(name, n):
    check_plain_version(name, n)


def test_plain_version_singular_saturates(monkeypatch):
    """Singular matrices run the division-by-zero saturation path."""
    zero_divisors = []
    divide = packed.packed_long_division

    def spy(dividend, divisor, *args, **kwargs):
        zero_divisors.append(int((divisor == 0).sum()))
        return divide(dividend, divisor, *args, **kwargs)

    monkeypatch.setattr(packed, "packed_long_division", spy)
    check_plain_version("low", 3, singular=True)
    assert sum(zero_divisors) > 0


def test_plain_version_base_four():
    check_plain_version("low", 3, qfloat_base=4, qfloat_len=11, qfloat_ints=4)


def test_wrapper_on_cpu_runs_plain_version():
    mags, signs, args, ref_m, ref_s = check_plain_version("high", 3)
    before = fused_inverse.LAUNCHES
    tm, ts = torch.from_numpy(mags), torch.from_numpy(signs)
    for lowering in (None, "auto", "unroll", "fused"):
        got_m, got_s = mt.qfloat_matrix_inverse_packed_io(tm, ts, *args, lowering=lowering)
        assert torch.equal(got_m, ref_m) and torch.equal(got_s, ref_s)
    got_m, got_s = fused_inverse.fused_matrix_inverse(tm[:5].reshape(5, 1, 9), ts[:5].reshape(5, 1, 9), *args)
    assert got_m.shape == (5, 1, 9) and torch.equal(got_m.reshape(5, 9), ref_m[:5])
    assert fused_inverse.LAUNCHES == before


def test_tracked_wrapper_on_cpu_runs_plain_version():
    mags, signs, args, ref_m, ref_s = check_plain_version("high", 3)
    before = (fused_inverse.LAUNCHES, fused_inverse.TRACKED_LAUNCHES)
    tm, ts = torch.from_numpy(mags), torch.from_numpy(signs)
    ref = fused_inverse.fused_matrix_inverse_reference(tm, ts, *args, track=True)
    assert torch.equal(ref[0], ref_m) and torch.equal(ref[1], ref_s)
    assert ref[2].dtype == torch.int32 and ref[2].shape == (48,)
    for lowering in (None, "auto", "unroll", "fused"):
        got = mt.qfloat_matrix_inverse_with_overflow(tm, ts, *args, lowering=lowering)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got = fused_inverse.fused_matrix_inverse(
        tm[:6].reshape(3, 2, 9), ts[:6].reshape(3, 2, 9), *args, track=True
    )
    assert got[0].shape == (3, 2, 9) and got[2].shape == (3, 2)
    assert torch.equal(got[0].reshape(6, 9), ref_m[:6]) and torch.equal(got[2].reshape(6), ref[2][:6])
    assert (fused_inverse.LAUNCHES, fused_inverse.TRACKED_LAUNCHES) == before
    meta = torch.zeros(9, 4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_inverse.fused_inverse_cell_major(meta, meta, *args, track=True)


@pytest.mark.parametrize("lowering", ["vec", "scan"])
def test_with_overflow_unported_lowerings_name_roadmap(lowering):
    """"vec" and "scan" run the op-by-op path, tracked: the same outputs,
    flags included, as "unroll" (the name dates from when they raised).
    tests/test_torch_large_n.py holds that path against JAX."""
    mags, signs, args, ref_m, ref_s = check_plain_version("high", 4)
    tm, ts = torch.from_numpy(mags), torch.from_numpy(signs)
    tm[0], ts[0] = 0, 1  # a zero matrix: its divisions saturate and flag
    got = mt.qfloat_matrix_inverse_with_overflow(tm, ts, *args, lowering=lowering)
    ref = mt.qfloat_matrix_inverse_with_overflow(tm, ts, *args, lowering="unroll")
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert got[2][0] == 1 and not got[2].all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = mt.HIGH
    args = (p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    meta = torch.zeros(8, 16, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_inverse.fused_matrix_inverse(meta, meta, 4, *args)
    cpu = torch.zeros(8, 169, dtype=torch.int64)
    with pytest.raises(ValueError, match="n in"):
        fused_inverse.fused_matrix_inverse(cpu, cpu, 13, *args)
    with pytest.raises(ValueError, match="lowering"):
        mt.qfloat_matrix_inverse_packed_io(cpu[:, :16], cpu[:, :16], 4, *args, lowering="tile")


def test_batched_api_matches_jax_end_to_end():
    p = mt.HIGH.replace(n=3)
    B = 16
    M = np.random.RandomState(5).randn(B, 3, 3) * 100
    port = mt.BatchedMatrixInversion(p, B, device="cpu", backend="packed", io="packed")
    ref = JaxBatched(mi.HIGH.replace(n=3), B, backend="packed", io="packed")
    got = port.run(M)
    np.testing.assert_array_equal(got, ref.run(M))
    assert np.max(np.abs(got - np.linalg.inv(M))) < 1e-3
    mags, signs = port.quantize(M)
    assert mags.device == torch.device("cpu") and mags.shape == (B, 9)
    out = port.run_raw(mags, signs)
    np.testing.assert_array_equal(port.dequantize(out), got)


@pytest.mark.parametrize("option", ["out_shardings", "data_parallel", "in_shardings"])
def test_batched_api_unported_options_name_roadmap(option):
    """The options that raised until multi-device batching was ported
    (ROADMAP item 10) now run over the CPU mesh, each equal to the
    one-device run: the batch sharded over ``data`` through either
    sharding, and ``data_parallel=True`` (K1's plain version per shard)."""
    p = mt.HIGH.replace(n=4)
    mesh = make_mesh(device="cpu")
    kw = {"data_parallel": True} if option == "data_parallel" else {
        option: NamedSharding(mesh, P("data", None))}
    M = np.random.RandomState(7).randn(8, 4, 4) * 100
    sharded = mt.BatchedMatrixInversion(p, 8, backend="packed", io="packed", device="cpu", **kw)
    one = mt.BatchedMatrixInversion(p, 8, backend="packed", io="packed", device="cpu")
    assert sharded.mesh.shape == {"data": 8} and sharded.device == torch.device("cpu")
    np.testing.assert_array_equal(sharded.run(M), one.run(M))


def test_batched_api_takes_the_reference_positional_order():
    """``(params, batch_size, backend, io, in_shardings, out_shardings,
    donate, data_parallel, track_overflow)`` as the JAX package's, with
    ``device`` keyword-only after them."""
    p = mt.HIGH.replace(n=3)
    M = np.random.RandomState(6).randn(4, 3, 3) * 100
    port = mt.BatchedMatrixInversion(p, 4, "packed", "packed", device="cpu")
    ref = JaxBatched(mi.HIGH.replace(n=3), 4, "packed", "packed")
    np.testing.assert_array_equal(port.run(M), ref.run(M))
    # donate is a no-op, data_parallel=None is one device, the ninth is track_overflow
    tracked = mt.BatchedMatrixInversion(p, 4, "packed", "packed", None, None, True, None, True,
                                        device="cpu")
    jtracked = JaxBatched(mi.HIGH.replace(n=3), 4, "packed", "packed", None, None, False, False,
                          True)
    (inv, flags), (jinv, jflags) = tracked.run(M), jtracked.run(M)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(flags, np.asarray(jflags))
    with pytest.raises(TypeError):
        mt.BatchedMatrixInversion(p, 4, "packed", "packed", None, None, False, None, False, "cpu")


@pytest.mark.parametrize("io", ["digits", "limbs"])
def test_batched_api_io_errors_are_the_reference_ones(io):
    """``track_overflow`` with another io than packed, and an unknown io,
    raise the reference's ``ValueError``s."""
    p, jp = mt.HIGH.replace(n=3), mi.HIGH.replace(n=3)
    match = "track_overflow requires io='packed'" if io == "digits" else "io must be"
    with pytest.raises(ValueError, match=match):
        mt.BatchedMatrixInversion(p, 4, "packed", io, track_overflow=True, device="cpu")
    with pytest.raises(ValueError, match=match):
        JaxBatched(jp, 4, "packed", io, track_overflow=True)


def test_batched_api_track_overflow():
    """``track_overflow=True`` (ROADMAP item 6) runs the tracked circuit:
    the same inverses as untracked, plus an int32 flag per matrix."""
    p = mt.HIGH.replace(n=4)
    M = np.random.RandomState(8).randn(8, 4, 4) * 100
    M[3] = 0.0  # singular: the divisions by zero saturate and flag
    tracked = mt.BatchedMatrixInversion(p, 8, io="packed", device="cpu", track_overflow=True)
    inv, flags = tracked.run(M)
    assert flags.dtype == np.int32 and flags.shape == (8,)
    assert flags[3] == 1 and flags.sum() < 8
    np.testing.assert_array_equal(
        inv, mt.BatchedMatrixInversion(p, 8, io="packed", device="cpu").run(M))
    ok = flags == 0
    assert np.max(np.abs(inv[ok] - np.linalg.inv(M[ok]))) < 1e-3


def test_batched_api_checks_inputs():
    inv = mt.BatchedMatrixInversion(mt.LOW.replace(n=2), 4, io="packed", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        inv.run(np.zeros((3, 2, 2)))
    with pytest.raises(ValueError, match="shape"):
        inv.run_raw(torch.zeros(4, 9, dtype=torch.int64), torch.zeros(4, 9, dtype=torch.int64))
    meta = torch.zeros(4, 4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="expected tensors on cpu"):
        inv.run_raw(meta, meta)
