"""Port vs JAX package: digit I/O on the packed backend.

``qfloat_matrix_inverse(..., backend="packed")``, the digit converters,
``BatchedMatrixInversion(io="digits")`` and ``EncryptedMatrixInversion``
are held bit for bit (int32 arrays equal) to the JAX package on the same
numpy inputs.  On the CPU the JAX entry point takes its object path at
n <= 8 and packs at n >= 9; the port always packs.  Both give the same bits
because every output cell of the inverse is a QFloat.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import inverse as jax_inverse
from matrix_inversion_tpu.models import marshal as jax_marshal
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched
from matrix_inversion_tpu.runtime.api import EncryptedMatrixInversion as JaxEncrypted

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models import inverse, marshal
from matrix_inversion_tpu_torch.ops import packed

torch.set_num_threads(2)


def digits_of(p, M):
    return marshal.float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)


def near_singular(rng, n):
    """A x100 matrix whose second row is its first times (1 + 1e-12): its
    inverse overflows the integer range."""
    M = rng.randn(n, n) * 100
    M[1] = M[0] * (1 + 1e-12)
    return M


@pytest.mark.parametrize("name,n,B", [("low", 2, 8), ("medium+", 3, 8), ("high", 4, 8),
                                      ("low", 13, 3)])
def test_qfloat_matrix_inverse_matches_jax(name, n, B):
    p = mt.PRESETS[name].replace(n=n)
    M = np.random.RandomState(n).randn(B, n, n) * 100
    M[0] = 0.0  # division by zero saturates
    d, s = digits_of(p, M)
    args = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    ref = np.asarray(jax_inverse.qfloat_matrix_inverse(
        jnp.asarray(d), jnp.asarray(s), *args, backend="packed"))
    got = mt.qfloat_matrix_inverse(torch.from_numpy(d), torch.from_numpy(s), *args,
                                   backend="packed")
    assert got.dtype == torch.int32 and got.shape == (B, n * n, p.qfloat_len + 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    # tensorize regroups limb ops only; int32 signs are taken too
    again = mt.qfloat_matrix_inverse(torch.from_numpy(d), torch.from_numpy(s.astype(np.int32)),
                                     *args, tensorize=True, backend="packed", lowering="unroll")
    assert torch.equal(again, got)
    # the packed-I/O circuit between the same pack and unpack
    mags, signs = mt.qfloat_matrix_inverse_packed_io(
        packed.digits_to_mags(torch.from_numpy(d), 1), torch.from_numpy(s), *args)
    assert torch.equal(packed.mags_to_digits(mags, p.qfloat_len, 1), got[..., :-1])
    assert torch.equal(signs.to(torch.int32), got[..., -1])


def test_qfloat_matrix_inverse_one_matrix_and_errors():
    p = mt.HIGH.replace(n=3)
    M = np.random.RandomState(1).randn(3, 3) * 100
    d, s = digits_of(p, M)
    args = (3, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    got = mt.qfloat_matrix_inverse(torch.from_numpy(d), torch.from_numpy(s), *args,
                                   backend="packed")
    ref = np.asarray(jax_inverse.qfloat_matrix_inverse(
        jnp.asarray(d), jnp.asarray(s), *args, backend="packed"))
    assert got.shape == (9, 41)
    np.testing.assert_array_equal(got.numpy(), ref)
    td, ts = torch.from_numpy(d), torch.from_numpy(s)
    # the limb backend (and "auto", and the reference's default) gives the same bits
    for backend in ("limb", "auto"):
        assert torch.equal(mt.qfloat_matrix_inverse(td, ts, *args, backend=backend), got)
    assert torch.equal(mt.qfloat_matrix_inverse(td, ts, *args), got)
    with pytest.raises(ValueError, match="expected"):
        mt.qfloat_matrix_inverse(td[:, :30], ts, *args, backend="packed")
    with pytest.raises(ValueError, match="expected"):
        mt.qfloat_matrix_inverse(td, ts[:4], *args, backend="packed")
    # host arrays are refused, not run on the CPU; both tensors on one device
    for dd, ss in ((d, s), (td, s), (d, ts)):
        with pytest.raises(TypeError, match="torch tensors"):
            mt.qfloat_matrix_inverse(dd, ss, *args, backend="packed")
    with pytest.raises(ValueError, match="one device"):
        mt.qfloat_matrix_inverse(td, ts.to("meta"), *args, backend="packed")


def test_digit_converters_match_jax():
    """Quantize, cells, back to arrays with the reference's encoding of
    ``SignedBinary`` and ``Zero`` cells, and dequantize."""
    p = mt.MEDIUM
    M = np.random.RandomState(2).randn(5, 3, 3) * 100
    M[0, 0, 0] = 0.0
    d, s = digits_of(p, M)
    jd, js = jax_marshal.float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, 2)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(s, js)
    assert d.dtype == np.int64 and d.shape == (5, 9, 31) and s.shape == (5, 9)

    def round_trip(conv, to_arrays, arrays, signs):
        cells = conv(arrays, signs, p.qfloat_ints, 2, backend="packed")
        cells[0][1] = mt.SignedBinary(-1) if conv is marshal.qfloat_arrays_to_qfloat_matrix \
            else mi.SignedBinary(-1)
        cells[1][2] = mt.SignedBinary(1) if conv is marshal.qfloat_arrays_to_qfloat_matrix \
            else mi.SignedBinary(1)
        cells[2][0] = mt.Zero() if conv is marshal.qfloat_arrays_to_qfloat_matrix else mi.Zero()
        return np.asarray(to_arrays(cells, p.qfloat_len, p.qfloat_ints, 2))

    got = round_trip(marshal.qfloat_arrays_to_qfloat_matrix,
                     marshal.qfloat_matrix_to_arrays_and_signs,
                     torch.from_numpy(d), torch.from_numpy(s))
    ref = round_trip(jax_marshal.qfloat_arrays_to_qfloat_matrix,
                     jax_marshal.qfloat_matrix_to_arrays_and_signs,
                     jnp.asarray(d), jnp.asarray(s))
    assert got.dtype == np.int32 and got.shape == (5, 9, 32)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 1, [p.qfloat_ints - 1, -1]], -1)
    np.testing.assert_array_equal(got[:, 6], 0)
    np.testing.assert_array_equal(got[:, 0, :-1], d[:, 0])
    np.testing.assert_array_equal(
        marshal.qfloat_and_signs_arrays_to_float_matrix(got, p.qfloat_ints, 2),
        jax_marshal.qfloat_and_signs_arrays_to_float_matrix(ref, p.qfloat_ints, 2),
    )
    # the reference's default backend builds limb cells: the same arrays back
    limb = marshal.qfloat_arrays_to_qfloat_matrix(torch.from_numpy(d), torch.from_numpy(s),
                                                  p.qfloat_ints, 2)
    jlimb = jax_marshal.qfloat_arrays_to_qfloat_matrix(jnp.asarray(d), jnp.asarray(s),
                                                       p.qfloat_ints, 2)
    assert isinstance(limb[0][0], mt.QFloat)
    np.testing.assert_array_equal(
        np.asarray(marshal.qfloat_matrix_to_arrays_and_signs(limb, p.qfloat_len, p.qfloat_ints, 2)),
        np.asarray(jax_marshal.qfloat_matrix_to_arrays_and_signs(jlimb, p.qfloat_len,
                                                                 p.qfloat_ints, 2)))


def test_packed_qfloat_digit_conversions_match_jax():
    rng = np.random.RandomState(3)
    digits = rng.randint(0, 16, size=(6, 12))
    signs = rng.choice([-1, 1], size=6)
    q = mt.PackedQFloat.from_digits(torch.from_numpy(digits), 5, 16, torch.from_numpy(signs))
    jq = mi.PackedQFloat.from_digits(jnp.asarray(digits), 5, 16, jnp.asarray(signs))
    np.testing.assert_array_equal(q.mag.numpy(), np.asarray(jq.mag))
    assert len(q) == 12 and q.ints == 5
    assert q.to_digits().dtype == torch.int32
    np.testing.assert_array_equal(q.to_digits().numpy(), np.asarray(jq.to_digits()))
    np.testing.assert_array_equal(q.to_array().numpy(), digits)
    np.testing.assert_array_equal(q.to_float(), jq.to_float())


def test_batched_digits_matches_jax():
    p = mt.HIGH.replace(n=3)
    B = 8
    M = np.random.RandomState(4).randn(B, 3, 3) * 100
    port = mt.BatchedMatrixInversion(p, B, device="cpu")
    assert port.io == "digits"
    ref = JaxBatched(mi.HIGH.replace(n=3), B, backend="packed", io="digits")
    got = port.run(M)
    np.testing.assert_array_equal(got, ref.run(M))
    assert np.max(np.abs(got - np.linalg.inv(M))) < 1e-3
    d, s = port.quantize(M)
    assert d.dtype == torch.int64 and d.shape == (B, 9, 40) and s.shape == (B, 9)
    out = port.run_raw(d, s)
    assert out.dtype == torch.int32 and out.shape == (B, 9, 41)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.run_raw(jnp.asarray(d.numpy()),
                                                                      jnp.asarray(s.numpy()))))
    np.testing.assert_array_equal(port.dequantize(out), got)
    # the packed path on the same matrices gives the same inverses
    np.testing.assert_array_equal(
        mt.BatchedMatrixInversion(p, B, io="packed", device="cpu").run(M), got)
    with pytest.raises(ValueError, match="shapes"):
        port.run_raw(s, s)


def test_encrypted_lifecycle_n2_matches_jax():
    """JAX's ``test_lifecycle_n2``, on both packages and the same matrix."""
    rng = np.random.RandomState(5)
    sampler = lambda: rng.randn(2, 2) * 100  # noqa: E731
    kw = dict(qfloat_len=23, qfloat_ints=9, true_division=False)
    inv = mt.EncryptedMatrixInversion(2, sampler, **kw, device="cpu")
    ref = JaxEncrypted(2, sampler, **kw)
    M = sampler()
    q, s = inv.quantize(M)
    assert q.shape == (4, 23) and s.shape == (4,)
    enc = inv.encrypt(q, s)
    assert all(t.dtype == torch.int64 and t.device.type == "cpu" for t in enc)
    dec = inv.decrypt(inv.evaluate(enc))
    assert isinstance(dec, np.ndarray) and dec.shape == (4, 24) and dec.dtype == np.int32
    np.testing.assert_array_equal(dec, ref.decrypt(ref.evaluate(ref.encrypt(q, s))))
    out = inv.dequantize(dec)
    assert np.mean(np.abs(out - np.linalg.inv(M))) < 1.0
    out_run = inv.run(M)
    np.testing.assert_array_equal(out_run, out)
    np.testing.assert_array_equal(inv.run(M, simulate=True), out_run)
    np.testing.assert_array_equal(out_run, ref.run(M))
    assert inv.keygen() is None


def test_encrypted_packed_io_tracked_matches_jax():
    """Medium+'s format at n=3, packed io, tracked: the inverse and a
    scalar int flag, 0 on a random matrix and 1 on one whose inverse
    overflows; digit io gives the same inverse, and ``simulate=True`` the
    same bits."""
    rng = np.random.RandomState(6)
    kw = dict(qfloat_len=31, qfloat_ints=16, true_division=True)
    tracked = mt.EncryptedMatrixInversion(3, **kw, io="packed", track_overflow=True,
                                          device="cpu")
    ref = JaxEncrypted(3, **kw, io="packed", track_overflow=True)
    digit_io = mt.EncryptedMatrixInversion(3, **kw, device="cpu")
    for M, want in ((rng.randn(3, 3) * 100, 0), (near_singular(rng, 3), 1)):
        inv, flag = tracked.run(M)
        ref_inv, ref_flag = ref.run(M)
        assert type(flag) is int and flag == want == ref_flag
        np.testing.assert_array_equal(inv, ref_inv)
        sim_inv, sim_flag = tracked.run(M, simulate=True)
        np.testing.assert_array_equal(sim_inv, inv)
        assert sim_flag == flag
        np.testing.assert_array_equal(digit_io.run(M), inv)
    mags, signs = tracked.quantize(M)
    assert mags.shape == (9,) and signs.shape == (9,)
    dec = tracked.decrypt(tracked.evaluate(tracked.encrypt(mags, signs)))
    assert isinstance(dec, tuple) and len(dec) == 3 and dec[2].shape == ()


def test_encrypted_default_format_matches_jax():
    M = np.random.RandomState(7).randn(2, 2) * 100
    got = mt.EncryptedMatrixInversion(2, device="cpu")
    assert (got.params.qfloat_len, got.params.qfloat_ints, got.io) == (32, 16, "digits")
    np.testing.assert_array_equal(got.run(M), JaxEncrypted(2).run(M))


def test_encrypted_checks_inputs_and_raises_the_reference_errors():
    inv = mt.EncryptedMatrixInversion(2, qfloat_len=23, qfloat_ints=9, device="cpu")
    with pytest.raises(AssertionError):
        inv.run(np.zeros((3, 3)))
    with pytest.raises(AssertionError):
        inv.run(np.zeros((2, 2), dtype=int))
    with pytest.raises(AssertionError):
        mt.EncryptedMatrixInversion(2, lambda: np.zeros((3, 3)), device="cpu")
    with pytest.raises(ValueError, match="io must be"):
        mt.EncryptedMatrixInversion(2, io="limbs", device="cpu")
    with pytest.raises(ValueError, match="track_overflow requires io='packed'"):
        mt.EncryptedMatrixInversion(2, track_overflow=True, device="cpu")
    with pytest.raises(ValueError, match="track_overflow requires io='packed'"):
        JaxEncrypted(2, track_overflow=True)
    # packed io needs the packed backend; a format only the limb backend holds
    # takes it
    with pytest.raises(ValueError, match="packed io requires the packed backend"):
        mt.EncryptedMatrixInversion(3, backend="limb", io="packed", device="cpu")
    with pytest.raises(ValueError, match="packed io requires the packed backend"):
        JaxEncrypted(3, backend="limb", io="packed")
    assert mt.EncryptedMatrixInversion(3, qfloat_base=3, device="cpu").backend == "limb"


def test_encrypted_defaults_to_the_card_and_raises_without_one():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device"):
        mt.EncryptedMatrixInversion(2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mt.EncryptedMatrixInversion(2, io="packed", device="cuda:0")
    with pytest.raises(TypeError):
        mt.EncryptedMatrixInversion(2, None, 2, 23, 9, False, False, "auto", "digits", False,
                                    "cpu")


def test_new_exports_match_jax():
    names = ["qfloat_matrix_inverse", "qfloat_pivot", "qfloat_lu_L", "qfloat_lu_U",
             "float_matrix_to_qfloat_arrays", "qfloat_and_signs_arrays_to_float_matrix",
             "EncryptedMatrixInversion"]
    for name in names:
        assert name in mt.__all__ and name in mi.__all__
    assert set(mi.__all__) <= set(mt.__all__)  # QFloat included
    assert mt.qfloat_matrix_inverse is inverse.qfloat_matrix_inverse
    assert mt.qfloat_pivot is inverse.qfloat_pivot
    assert mt.float_matrix_to_qfloat_arrays is marshal.float_matrix_to_qfloat_arrays
    assert mt.qfloat_and_signs_arrays_to_float_matrix is \
        marshal.qfloat_and_signs_arrays_to_float_matrix
