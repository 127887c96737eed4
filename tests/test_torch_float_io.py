"""The float stream's quantize and dequantize kernels (``csrc/float_io.cu``,
``ops/float_io.py``) against the host route, bit for bit.

The kernels are built with g++ (the file's host form runs each kernel's
threads in a loop) and held to the native marshaller's
``quantize_packed``/``dequantize_packed`` (``csrc/qmarshal.cc``, the route
the stream takes on the host) and to the plain versions, over normal(0, 100)
values and the edges: +-0.0, subnormals, integer parts that wrap past
``ints`` digits, 2**52 to 2**63 and beyond, +-inf and NaN; at the High
format, the control's 31/16 and bases 2, 4 and 16; at ragged sizes, aligned
and 8 bytes off 16-byte alignment.  Then the wrappers with the host form in
place of the launch, and every raise they document.
"""

import contextlib

import numpy as np
import pytest
import torch

from matrix_inversion_tpu_torch.ops import float_io
from matrix_inversion_tpu_torch.runtime import native
from matrix_inversion_tpu_torch.utils import profiling

import float_io_host

torch.set_num_threads(2)

# (length, ints, base): High, the control's MEDIUM+ (31/16), Low, and the
# widest packed formats at bases 4 and 16
FORMATS = [(40, 20, 2), (31, 16, 2), (23, 9, 2), (31, 16, 4), (15, 7, 16)]
SIZES = [1, 2, 3, 37, 4097]

EDGES = [
    0.0, -0.0, 5e-324, -5e-324, 1e-310, -1e-310, 2.2250738585072014e-308, 2.0 ** -60,
    0.5, -0.5, 1.0 - 2.0 ** -53, 1.0, -1.0, 2.0 ** -20, 2.0 ** -21, -(2.0 ** -21),
    # integer parts past ints digits: they keep their low digits
    2.0 ** 9 - 2.0 ** -14, 2.0 ** 9, 2.0 ** 16 + 0.25, 2.0 ** 20 - 2.0 ** -20, 2.0 ** 20,
    -(2.0 ** 20 + 0.75), 3e6, -1e7, 123456789.123456, 2.0 ** 40 + 3.5,
    # 2**52 to 2**63 and beyond
    2.0 ** 52, 2.0 ** 52 + 1, -(2.0 ** 52 + 3), 2.0 ** 53, 2.0 ** 62 + 2.0 ** 40, -(2.0 ** 62),
    2.0 ** 63 - 1024, -(2.0 ** 63 - 1024), 2.0 ** 63, -(2.0 ** 63), 2.0 ** 64, 1e19, -1e19,
    1e300, -1e300, np.finfo(np.float64).max, -np.finfo(np.float64).max,
    np.inf, -np.inf, np.nan, -np.nan,
]


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return float_io_host.build(tmp_path_factory.mktemp("float_io_host"))


@pytest.fixture
def kernel_route(monkeypatch, host_kernels):
    float_io_host.kernel_route(monkeypatch, host_kernels)
    profiling.reset()


def values_of(size, seed):
    """``size`` float64 values drawn without replacement from the edges and
    ``size`` normal(0, 100) values: every edge where ``size`` is past them
    all."""
    rng = np.random.RandomState(seed)
    values = np.concatenate([np.array(EDGES), rng.normal(0, 100, size)])
    if size >= len(EDGES):
        return values[:size]
    return rng.permutation(values)[:size]


def placed(array, offset):
    """``array`` as a contiguous tensor ``offset`` elements into its storage
    (8 bytes off 16-byte alignment where odd and the storage is aligned)."""
    flat = torch.zeros(offset + array.size, dtype=torch.from_numpy(array).dtype)
    t = flat[offset:]
    t.copy_(torch.from_numpy(array.reshape(-1)))
    return t


def bits_of(t):
    """The float64 tensor ``t``'s bits, as int64."""
    return t.view(torch.int64)


def run_quantize(host_kernels, values, length, ints, base, offset):
    v = placed(values, offset)
    mags = placed(np.full(values.size, -7, np.int64), offset)
    signs = placed(np.full(values.size, -7, np.int64), 0)
    assert host_kernels["float_quantize"](v.data_ptr(), mags.data_ptr(), signs.data_ptr(),
                                          values.size, length, ints,
                                          float_io.format_bits(length, ints, base)) == 0
    return mags, signs


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("length,ints,base", FORMATS)
def test_quantize_host_form_matches_native_and_plain(host_kernels, length, ints, base, size):
    """The quantize kernel's code == ``qmarshal.cc::quantize_packed`` ==
    ``quantize_reference``, bit for bit, on the edges and normal values,
    arrays aligned and 8 bytes off."""
    values = values_of(size, seed=size + length)
    want_mags, want_signs = native.quantize_packed(values, length, ints, base)
    plain = float_io.quantize_reference(torch.from_numpy(values), length, ints, base)
    np.testing.assert_array_equal(plain[0].numpy(), want_mags)
    np.testing.assert_array_equal(plain[1].numpy(), want_signs)
    for offset in (0, 1):
        mags, signs = run_quantize(host_kernels, values, length, ints, base, offset)
        np.testing.assert_array_equal(mags.numpy(), want_mags)
        np.testing.assert_array_equal(signs.numpy(), want_signs)


def test_quantize_edges_read_as_the_host_route_gives_them():
    """What the host route gives at the edges, which the kernel has to
    reproduce rather than take from the card's conversion: 0 for integer
    parts of 2**63 and more, -2**63 for +-inf and NaN, +1 the sign of
    +-0.0 and NaN, the low ``ints`` digits of a wide integer part."""
    values = np.array([2.0 ** 63, -(2.0 ** 64), np.inf, -np.inf, np.nan, -0.0, 0.0,
                       2.0 ** 20 + 0.5, -(2.0 ** 62)])
    mags, signs = native.quantize_packed(values, 40, 20, 2)
    assert mags.tolist() == [0, 0, -2 ** 63, -2 ** 63, -2 ** 63, 0, 0, 2 ** 19, 0]
    assert signs.tolist() == [1, -1, 1, -1, 1, 1, 1, 1, -1]


def dequantize_inputs(size, length, ints, base, seed):
    """Magnitudes from the quantize of ``values_of``, then any int64; signs
    mostly in {-1, 0, 1}, some any int64."""
    rng = np.random.RandomState(seed)
    mags, signs = native.quantize_packed(values_of(size, seed), length, ints, base)
    wild = rng.randint(-2 ** 63, 2 ** 63 - 1, size=size, dtype=np.int64)
    mags = np.where(rng.rand(size) < 0.5, mags, wild)
    odd = rng.choice(np.array([3, -7, 2 ** 53 + 1, -2 ** 62], dtype=np.int64), size=size)
    signs = np.where(rng.rand(size) < 0.8, rng.randint(-1, 2, size=size), odd).astype(np.int64)
    return mags, signs


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("length,ints,base", FORMATS)
def test_dequantize_host_form_matches_native_and_plain(host_kernels, length, ints, base, size):
    """The dequantize kernel's code == ``qmarshal.cc::dequantize_packed`` ==
    ``dequantize_reference``, bit for bit (-0.0 included), arrays aligned
    and 8 bytes off."""
    mags, signs = dequantize_inputs(size, length, ints, base, seed=3 * size + ints)
    want = native.dequantize_packed(mags, signs, length, ints, base)
    plain = float_io.dequantize_reference(torch.from_numpy(mags), torch.from_numpy(signs),
                                          length, ints, base)
    np.testing.assert_array_equal(bits_of(plain).numpy(), want.view(np.int64))
    scale = float_io.dequantize_scale(length, ints, base)
    for offset, signs_offset in ((0, 0), (1, 1), (0, 1)):
        m, s = placed(mags, offset), placed(signs, signs_offset)
        out = placed(np.full(size, np.nan), offset)
        assert host_kernels["float_dequantize"](m.data_ptr(), s.data_ptr(), out.data_ptr(),
                                                size, scale) == 0
        np.testing.assert_array_equal(bits_of(out).numpy(), want.view(np.int64))


def test_dequantize_scale_is_the_host_routes():
    for length, ints, base in FORMATS:
        assert float_io.dequantize_scale(length, ints, base) == 2.0 ** (
            -(base.bit_length() - 1) * (length - ints))


def test_round_trip_on_the_grid(host_kernels):
    """Values on the format's grid come back exactly through both kernels."""
    rng = np.random.RandomState(5)
    values = rng.randint(-2 ** 39, 2 ** 39, size=1001) / 2.0 ** 20
    mags, signs = run_quantize(host_kernels, values, 40, 20, 2, 0)
    out = torch.empty(values.size, dtype=torch.float64)
    assert host_kernels["float_dequantize"](mags.data_ptr(), signs.data_ptr(), out.data_ptr(),
                                            values.size, 2.0 ** -20) == 0
    np.testing.assert_array_equal(out.numpy(), values)


def test_entry_points_refuse_what_they_do_not_take(host_kernels):
    """Arguments outside the format's range return cudaErrorInvalidValue
    (1), as a refused launch does, and write nothing."""
    v = torch.ones(4, dtype=torch.float64)
    mags = torch.full((4,), -7, dtype=torch.int64)
    for length, ints, bits in ((40, 20, 0), (40, 41, 1), (40, -1, 1), (63, 20, 1), (32, 16, 2)):
        assert host_kernels["float_quantize"](v.data_ptr(), mags.data_ptr(), mags.data_ptr(), 4,
                                              length, ints, bits) == 1
    assert host_kernels["float_quantize"](v.data_ptr(), mags.data_ptr(), mags.data_ptr(), -1,
                                          40, 20, 1) == 1
    assert host_kernels["float_dequantize"](mags.data_ptr(), mags.data_ptr(), v.data_ptr(), -1,
                                            1.0) == 1
    assert (mags == -7).all() and (v == 1).all()


@pytest.mark.parametrize("shape", [(5, 16), (3, 7, 11), (0, 16)])
def test_wrappers_on_the_kernel_route(kernel_route, shape):
    """``quantize`` and ``dequantize`` with the host form in place of the
    launch: the plain versions' bits, the input's shape, one launch each
    (none for an empty batch)."""
    size = int(np.prod(shape))
    values = torch.from_numpy(values_of(size, seed=9)[:size].reshape(shape).copy())
    mags, signs = float_io.quantize(values, 40, 20, 2)
    want = float_io.quantize_reference(values, 40, 20, 2)
    assert mags.shape == signs.shape == values.shape and mags.dtype == signs.dtype == torch.int64
    assert torch.equal(mags, want[0]) and torch.equal(signs, want[1])
    out = float_io.dequantize(mags, signs, 40, 20, 2)
    assert out.shape == values.shape and out.dtype == torch.float64
    assert torch.equal(bits_of(out), bits_of(float_io.dequantize_reference(mags, signs, 40, 20, 2)))
    launched = 1 if size else 0
    assert (profiling.launches("float_quantize"),
            profiling.launches("float_dequantize")) == (launched, launched)


def refused_launch(monkeypatch):
    """``_launch`` as it is, on a library whose launches all return
    cudaErrorInvalidValue, with the card's device scope and stream stubbed."""
    monkeypatch.setattr(float_io, "_check_device", lambda t, what: None)
    monkeypatch.setattr(float_io, "_library", lambda entry: lambda *args: 1)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())


F64 = torch.zeros(4, dtype=torch.float64)
I64 = torch.zeros(4, dtype=torch.int64)
RAISES = {
    "quantize on the CPU": (lambda: float_io.quantize(F64, 40, 20, 2), ValueError, "CUDA tensor"),
    "dequantize on the CPU": (lambda: float_io.dequantize(I64, I64, 40, 20, 2), ValueError,
                              "CUDA tensor"),
    "float32 values": (lambda: float_io.quantize(F64.float(), 40, 20, 2), TypeError, "float64"),
    "int32 magnitudes": (lambda: float_io.dequantize(I64.int(), I64, 40, 20, 2), TypeError,
                         "int64"),
    "int32 signs": (lambda: float_io.dequantize(I64, I64.int(), 40, 20, 2), TypeError, "int64"),
    "values not contiguous": (lambda: float_io.quantize(torch.zeros(4, 2, dtype=torch.float64).t(),
                                                        40, 20, 2), ValueError, "contiguous"),
    "magnitudes not contiguous": (
        lambda: float_io.dequantize(torch.zeros(4, 2, dtype=torch.int64).t(),
                                    torch.zeros(2, 4, dtype=torch.int64), 40, 20, 2),
        ValueError, "contiguous"),
    "signs of another shape": (lambda: float_io.dequantize(I64, I64[:3], 40, 20, 2), ValueError,
                               "signs"),
    "a base that is not a power of two": (lambda: float_io.quantize(F64, 12, 5, 10), ValueError,
                                          "power-of-two"),
    "a base below 2": (lambda: float_io.quantize(F64, 12, 5, 1), ValueError, "power-of-two"),
    "past 62 bits": (lambda: float_io.quantize(F64, 32, 16, 4), ValueError, "62"),
    "ints past length": (lambda: float_io.quantize(F64, 20, 21, 2), ValueError, "ints"),
    "negative ints": (lambda: float_io.quantize(F64, 20, -1, 2), ValueError, "ints"),
    "a refused quantize": (lambda: float_io.quantize(F64, 40, 20, 2), RuntimeError,
                           "float_quantize kernel launch failed: cudaError 1"),
    "a refused dequantize": (lambda: float_io.dequantize(I64, I64, 40, 20, 2), RuntimeError,
                             "float_dequantize kernel launch failed: cudaError 1"),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_wrappers_raise(request, monkeypatch, case):
    """What the wrappers refuse raises, and launches nothing: tensors off
    the card, the wrong dtypes, a tensor that is not contiguous, signs of
    another shape, a format the closed form does not hold for, and a launch
    the card refuses (``cudaGetLastError``)."""
    fn, error, match = RAISES[case]
    if case.startswith("a refused"):
        refused_launch(monkeypatch)
    elif "CUDA tensor" not in match:
        request.getfixturevalue("kernel_route")
    profiling.reset()
    with pytest.raises(error, match=match):
        fn()
    assert profiling.launches("float_quantize") == profiling.launches("float_dequantize") == 0
