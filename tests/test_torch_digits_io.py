"""Port vs JAX package: digit I/O on the packed backend.

``qfloat_matrix_inverse(..., backend="packed")``, the digit converters,
``BatchedMatrixInversion(io="digits")`` and ``EncryptedMatrixInversion``
are held bit for bit (int32 arrays equal) to the JAX package on the same
numpy inputs.  On the CPU the JAX entry point takes its object path at
n <= 8 and packs at n >= 9; the port always packs.  Both give the same bits
because every output cell of the inverse is a QFloat.

The pack and unpack kernels (``csrc/digit_io.cu``) are built with g++ (the
file's host form runs each kernel's phases as loops over a block's threads)
and held to the plain versions, alone and in place of the launch behind the
converters' kernel route, which CPU tensors then take.
"""

import contextlib
import ctypes
import subprocess

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
from matrix_inversion_tpu_torch.ops import digit_io, packed
from matrix_inversion_tpu_torch.ops.cuda_build import CSRC
from matrix_inversion_tpu_torch.utils import profiling

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


# ---- the digit converters: the plain versions, the kernels' host form -------

# (base, digits a row): every base of the packed backend's tests, up to the
# widest row of 62 bits
FORMATS = [(2, 1), (2, 40), (2, 62), (4, 1), (4, 20), (4, 31), (16, 1), (16, 10), (16, 15)]


def format_digits(base, length, shape, seed):
    """int64 digits in ``[0, base)``, the first row all ``base - 1`` and the
    second all 0."""
    digits = np.random.RandomState(seed).randint(0, base, size=shape + (length,))
    digits.reshape(-1, length)[:2] = [[base - 1], [0]]
    return digits.astype(np.int64)


@pytest.mark.parametrize("base,length", FORMATS)
def test_digit_converters_match_jax(base, length):
    """The CPU path of ``digits_to_mags``, ``mags_to_digits`` and
    ``digit_output`` against the JAX package's pack and unpack (the jnp
    expressions ``PackedQFloat.from_digits``/``to_digits``, which its digit
    circuit inlines), signs -1, 0 and 1 in the last column."""
    bits = packed.digit_bits(base)
    digits = format_digits(base, length, (3, 5), seed=base * 100 + length)
    signs = np.random.RandomState(length).choice([-1, 0, 1], size=(3, 5))
    jq = mi.PackedQFloat.from_digits(jnp.asarray(digits), length // 2, base, jnp.asarray(signs))
    mags = packed.digits_to_mags(torch.from_numpy(digits), bits)
    assert mags.dtype == torch.int64 and mags.shape == (3, 5)
    np.testing.assert_array_equal(mags.numpy(), np.asarray(jq.mag))
    jdigits = np.asarray(jq.to_digits())
    np.testing.assert_array_equal(jdigits, digits)
    got = packed.mags_to_digits(mags, length, bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jdigits)
    out = inverse.digit_output(mags, torch.from_numpy(signs), length, base)
    assert out.dtype == torch.int32 and out.shape == (3, 5, length + 1)
    np.testing.assert_array_equal(
        out.numpy(), np.concatenate([jdigits, signs[..., None].astype(np.int32)], -1))


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/digit_io.cu`` built with g++: ``{entry: its host function}``,
    the arguments of the launch functions less the stream."""
    lib = tmp_path_factory.mktemp("digit_io_host") / "digit_io.so"
    proc = subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-o",
                           str(lib), str(CSRC / "digit_io.cu")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"g++ failed:\n{proc.stderr}"
    dll = ctypes.CDLL(str(lib))
    out = {}
    for entry in ("digits_pack", "digits_unpack"):
        fn = getattr(dll, f"{entry}_host")
        fn.argtypes = digit_io._ARGTYPES[entry][:-1]
        fn.restype = ctypes.c_int
        out[entry] = fn
    return out


def unaligned(shape, dtype, fill=0):
    """A contiguous tensor of ``shape`` one element into its storage: 8 (or
    4) bytes off 16-byte alignment where the storage is aligned."""
    flat = torch.full((1 + int(np.prod(shape)),), fill, dtype=dtype)
    return flat[1:].view(shape)


# (cells, digits a row, bits): ragged tiles, one cell, odd and even rows,
# rows past 64 bits, a tile past 48 KB (the card's larger shared memory),
# rows too wide to stage (the pack at 300 digits, the unpack at 500)
HOST_CASES = [(1, 1, 1), (129, 40, 1), (300, 31, 2), (257, 15, 4), (130, 7, 3), (128, 100, 1),
              (5, 300, 1), (3, 500, 1)]


@pytest.mark.parametrize("cells,length,bits", HOST_CASES)
def test_kernels_host_form_match_plain(host_kernels, cells, length, bits):
    """Both kernels, through their tiles and their fallback past the
    card's shared memory, against the plain versions bit for bit: digits in
    range, and digits of any int64 (the sum wraps mod 2**64); magnitudes of
    any int64 (the shift is arithmetic); rows contiguous and aligned, 8
    bytes off 16-byte alignment, and a uniform stride apart in a wider
    output; with and without the sign column."""
    rng = np.random.RandomState(cells + length + bits)
    for digits in (rng.randint(0, 1 << bits, size=(cells, length)),
                   rng.randint(-2 ** 62, 2 ** 62, size=(cells, length))):
        want = packed.digits_to_mags_reference(torch.from_numpy(digits), bits)
        for d in (torch.from_numpy(digits), unaligned(digits.shape, torch.int64)):
            d.copy_(torch.from_numpy(digits))
            mags = torch.full((cells,), -1, dtype=torch.int64)
            assert host_kernels["digits_pack"](d.data_ptr(), mags.data_ptr(), cells, length,
                                               bits) == 0
            assert torch.equal(mags, want)
    mags = torch.from_numpy(rng.randint(-2 ** 63, 2 ** 63, size=cells, dtype=np.int64))
    signs = torch.from_numpy(rng.randint(-1, 2, size=cells).astype(np.int64))
    for sign in (None, signs):
        want = packed.mags_to_digits_reference(mags, length, bits, signs=sign)
        width = want.shape[-1]
        for out in (torch.full((cells, width), -7, dtype=torch.int32),
                    unaligned((cells, width), torch.int32, -7),
                    torch.full((cells, width + 3), -7, dtype=torch.int32)[:, 1:width + 1]):
            assert host_kernels["digits_unpack"](
                mags.data_ptr(), None if sign is None else sign.data_ptr(), out.data_ptr(),
                cells, length, digit_io.row_stride_of(out), bits) == 0
            assert torch.equal(out, want)
            base = out._base if out._base is not None else out
            assert int((base == -7).sum()) == base.numel() - out.numel()


@pytest.fixture
def kernel_route(monkeypatch, host_kernels):
    """The converters' kernel route on CPU tensors: ``ops/digit_io.py``'s
    wrappers with the host build in place of the launch, which counts under
    ``launch.<entry>`` as the launch does."""
    def launch(entry, *args, device):
        assert device.type == "cpu"
        assert host_kernels[entry](*args) == 0
        profiling.count("launch." + entry)

    monkeypatch.setattr(packed, "_digit_kernel", lambda t: True)
    monkeypatch.setattr(digit_io, "_check_device", lambda t, what: None)
    monkeypatch.setattr(digit_io, "_launch", launch)
    profiling.reset()


def launch_counts():
    return profiling.launches("digits_pack"), profiling.launches("digits_unpack")


def route_inputs(case):
    """``(digits, mags, signs, launches)`` of one kernel-route case at the
    High format: the launches one pack and one unpack make (none for an
    empty batch)."""
    rng = np.random.RandomState(len(case))
    digits = torch.from_numpy(format_digits(2, 40, (2, 3, 16), seed=11))
    signs = torch.from_numpy(rng.choice([-1, 0, 1], size=(2, 3, 16)))
    mags = packed.digits_to_mags_reference(digits, 1)
    if case == "empty batch":
        return digits[:0], mags[:0], signs[:0], (0, 0)
    if case == "int32 digits and signs":
        return digits.to(torch.int32), mags, signs.to(torch.int32), (1, 1)
    if case == "views that are not contiguous":
        wide = torch.zeros((2, 3, 32, 41), dtype=torch.int64)
        wide[:, :, ::2, 1:] = digits
        return wide[:, :, ::2, 1:], mags.transpose(0, 1), signs.transpose(0, 1), (1, 1)
    if case == "signs broadcast":
        return digits, mags, signs[..., :1], (1, 1)
    return digits, mags, signs, (1, 1)


@pytest.mark.parametrize("case", ["batch axes", "empty batch", "int32 digits and signs",
                                  "views that are not contiguous", "signs broadcast"])
def test_converters_kernel_route(kernel_route, case):
    """``digits_to_mags``, ``mags_to_digits`` and ``digit_output`` on the
    kernel route equal the plain versions, with one launch each (none for
    an empty batch): leading batch axes, an empty batch, int32 digits and
    signs, inputs that are not contiguous, signs broadcast over the cells."""
    digits, mags, signs, launches = route_inputs(case)
    want_mags = packed.digits_to_mags_reference(digits.to(torch.int64), 1)
    want_out = packed.mags_to_digits_reference(mags, 40, 1, signs=signs)
    got = packed.digits_to_mags(digits, 1)
    assert launch_counts() == (launches[0], 0)
    assert got.dtype == torch.int64 and torch.equal(got, want_mags)
    out = inverse.digit_output(mags, signs, 40, 2)
    assert launch_counts() == launches
    assert out.dtype == torch.int32 and out.shape == mags.shape + (41,)
    assert torch.equal(out, want_out)
    assert torch.equal(packed.mags_to_digits(mags, 40, 1), want_out[..., :40])
    # a run through the whole digit path at HIGH n=4 (K1's plain version on the CPU)
    if case == "batch axes":
        p = mt.HIGH.replace(n=4)
        args = (4, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
        d, s = digits_of(p, np.random.RandomState(12).randn(5, 4, 4) * 100)
        profiling.reset()
        got = mt.qfloat_matrix_inverse(torch.from_numpy(d), torch.from_numpy(s), *args,
                                       backend="packed")
        assert launch_counts() == (1, 1)
        ref = jax_inverse.qfloat_matrix_inverse(jnp.asarray(d), jnp.asarray(s), *args,
                                                backend="packed")
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("view", ["whole", "columns of a wider output", "rows spread apart",
                                  "rows not a uniform stride apart"])
def test_mags_to_digits_writes_into_out(request, route, view):
    """``mags_to_digits(..., out=...)`` writes the digits (and, with signs,
    the sign column) into ``out`` and nothing around it, on both routes:
    ``out`` whole, the columns of a wider output, every other row of one
    (rows a uniform stride apart), and rows that are not a uniform stride
    apart (the kernel route unpacks into a fresh tensor and copies, one
    launch)."""
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    mags = packed.digits_to_mags_reference(
        torch.from_numpy(format_digits(4, 20, (6, 4), seed=13)), 2)
    signs = torch.from_numpy(np.random.RandomState(13).choice([-1, 0, 1], size=(6, 4)))
    for sign, width in ((None, 20), (signs, 21)):
        base = torch.full((6, 8, width + 2), -7, dtype=torch.int32)
        out = {"whole": base[:, :4, :width],
               "columns of a wider output": base[:, :4, 1:width + 1],
               "rows spread apart": base[:, ::2, :width],
               "rows not a uniform stride apart": base[:, 2:6, 2:]}[view]
        if view == "whole":
            base = out = torch.full((6, 4, width), -7, dtype=torch.int32)
        profiling.reset()
        assert packed.mags_to_digits(mags, 20, 2, out=out, signs=sign) is out
        assert torch.equal(out, packed.mags_to_digits_reference(mags, 20, 2, signs=sign))
        assert int((base == -7).sum()) == base.numel() - out.numel()
        assert launch_counts() == ((0, 1) if route == "kernel" else (0, 0))


def test_row_stride_of():
    t = torch.zeros((2, 3, 6, 5), dtype=torch.int32)
    assert digit_io.row_stride_of(t) == 5
    assert digit_io.row_stride_of(t[..., 1:4]) == 5
    assert digit_io.row_stride_of(t[:, :, ::2]) == 10
    assert digit_io.row_stride_of(t[:, 1:2, 3:4]) == 90
    assert digit_io.row_stride_of(t[:, :, :3]) is None
    assert digit_io.row_stride_of(t.transpose(-1, -2)) is None
    assert digit_io.row_stride_of(torch.zeros((1, 5))[..., :1]) == 1
    assert digit_io.row_stride_of(torch.zeros(())) is None


def refused_launch(monkeypatch):
    """``_launch`` as it is, on a library whose launches all return
    cudaErrorInvalidValue, with the card's device scope and stream stubbed."""
    monkeypatch.setattr(digit_io, "_library", lambda entry: lambda *args: 1)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())


RAISES = {
    "pack on the CPU": (lambda: digit_io.pack(torch.zeros((2, 3), dtype=torch.int64), 1),
                        ValueError, "CUDA tensor"),
    "unpack on the CPU": (lambda: digit_io.unpack(torch.zeros(2, dtype=torch.int64),
                                                  torch.zeros((2, 3), dtype=torch.int32), 1),
                          ValueError, "CUDA tensor"),
    "converters off the CPU and the card": (
        lambda: packed.digits_to_mags(torch.zeros((2, 3), dtype=torch.int64, device="meta"), 1),
        ValueError, "CUDA tensor"),
    "bits 0": (lambda: packed.digits_to_mags(torch.zeros((2, 3), dtype=torch.int64), 0),
               ValueError, "bits"),
    "bits 64": (lambda: packed.mags_to_digits(torch.zeros(2, dtype=torch.int64), 1, 64),
                ValueError, "bits"),
    "no digit axis": (lambda: packed.digits_to_mags(torch.zeros((2, 0), dtype=torch.int64), 1),
                      ValueError, "digit axis"),
    "int32 magnitudes": (lambda: digit_io.unpack(torch.zeros(2, dtype=torch.int32),
                                                 torch.zeros((2, 3), dtype=torch.int32), 1),
                         TypeError, "int64"),
    "digits not contiguous": (
        lambda: digit_io.pack(torch.zeros((3, 2), dtype=torch.int64).t(), 1),
        ValueError, "contiguous"),
    "out not int32": (lambda: packed.mags_to_digits(torch.zeros(2, dtype=torch.int64), 3, 1,
                                                    out=torch.zeros((2, 3), dtype=torch.int64)),
                      ValueError, "int32"),
    "out of another width": (
        lambda: packed.mags_to_digits(torch.zeros(2, dtype=torch.int64), 3, 1,
                                      out=torch.zeros((2, 4), dtype=torch.int32)),
        ValueError, "columns"),
    "out of another batch": (
        lambda: packed.mags_to_digits(torch.zeros(2, dtype=torch.int64), 3, 1,
                                      out=torch.zeros((3, 3), dtype=torch.int32)),
        ValueError, "does not fit"),
    "signs of another shape": (
        lambda: digit_io.unpack(torch.zeros(2, dtype=torch.int64),
                                torch.zeros((2, 4), dtype=torch.int32), 1,
                                signs=torch.zeros(3, dtype=torch.int64)),
        ValueError, "signs"),
    "a refused launch": (lambda: digit_io.pack(torch.zeros((2, 3), dtype=torch.int64), 1),
                         RuntimeError, "launch failed: cudaError 1"),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_converters_raise(request, monkeypatch, case):
    """What the kernel route refuses raises, and launches nothing: tensors
    off the card (on the CPU the wrappers of ``ops/digit_io.py`` refuse
    them; the converters send them there from anywhere but the CPU), bits
    outside 1..63, an empty digit axis, the wrong dtypes, a tensor that is
    not contiguous where one must be, an ``out`` or signs that do not fit,
    and a launch the card refuses (``cudaGetLastError``)."""
    fn, error, match = RAISES[case]
    if case == "a refused launch":
        monkeypatch.setattr(digit_io, "_check_device", lambda t, what: None)
        refused_launch(monkeypatch)
    elif "CUDA tensor" not in match:
        request.getfixturevalue("kernel_route")
    profiling.reset()
    with pytest.raises(error, match=match):
        fn()
    assert launch_counts() == (0, 0)
