"""Port vs JAX package: the native marshaller (``runtime/native.py`` on
``csrc/qmarshal.cc``) and the converters' routing to it.

The port's library is built with g++ at first use into the package's
``_build/``.  Each of its five entry points is held bit for bit to the JAX
package's ``runtime/native`` (built with g++ from ``native/qmarshal.cc`` into
a temporary directory, as ``tests/test_torch_radix.py`` builds it) and to the
port's numpy route, at bases 2, 3, 10 and 16, on values whose integer part
overflows ``ints`` digits, on +-0.0 and on exact integers.  The one
tolerance: the digit dequantize sums in another order than numpy at bases
that are not powers of two, so there it is held to numpy within one ulp (bit
for bit at 2 and 16), as in the JAX package.  The converters take the
library at 4,096 values and numpy at 4,095, with the numpy route's dtypes;
a source that does not compile raises with the compiler's output.
"""

import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

from matrix_inversion_tpu.runtime import native as jax_native

from matrix_inversion_tpu_torch.models import marshal
from matrix_inversion_tpu_torch.ops import cuda_build, radix
from matrix_inversion_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parent.parent
# (base, len, ints): the closed form at the power-of-two bases with
# bits * len <= 62, the multiply-truncate loop at the others
FORMATS = [(2, 40, 20), (3, 20, 8), (10, 12, 5), (16, 12, 6)]


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native marshaller, built with g++ into a temporary
    directory and loaded for this module."""
    out = tmp_path_factory.mktemp("qmarshal") / "libqmarshal.so"
    build = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         str(REPO / "native" / "qmarshal.cc"), "-o", str(out)],
        capture_output=True, text=True,
    )
    assert build.returncode == 0, build.stderr
    saved = jax_native._LIB, jax_native._TRIED, os.environ.get("QMARSHAL_LIB")
    os.environ["QMARSHAL_LIB"] = str(out)
    jax_native._LIB, jax_native._TRIED = None, False
    try:
        assert jax_native.available()
        yield jax_native
    finally:
        jax_native._LIB, jax_native._TRIED = saved[:2]
        if saved[2] is None:
            del os.environ["QMARSHAL_LIB"]
        else:
            os.environ["QMARSHAL_LIB"] = saved[2]


def values(p, ints, seed, size=6000):
    """Values whose integer part fits ``ints`` digits, values up to 8 digits
    wider, +-0.0 and exact integers."""
    rng = np.random.RandomState(seed)
    top = min(float(p) ** ints, 1e15)
    f = rng.uniform(-1, 1, size=size) * top * rng.choice([1e-6, 1e-3, 1.0, 2.0, float(p) ** 8],
                                                         size=size)
    f[:6] = [0.0, -0.0, 1.0, -1.0, 0.5, -(top - 1)]
    return f


@pytest.mark.parametrize("p,length,ints", FORMATS)
def test_quantize_digits_matches_jax_and_numpy(jax_lib, monkeypatch, p, length, ints):
    f = values(p, ints, p).reshape(-1, 3)
    digits, signs = native.quantize_digits(f, length, ints, p)
    assert digits.dtype == np.int32 and signs.dtype == np.int32
    assert digits.shape == f.shape + (length,) and signs.shape == f.shape
    jd, js = jax_lib.quantize_digits(f, length, ints, p)
    np.testing.assert_array_equal(digits, jd)
    np.testing.assert_array_equal(signs, js)
    monkeypatch.setattr(native, "_LIB", False)
    nd, ns = radix.float_to_digits_and_sign(f, length, ints, p)
    np.testing.assert_array_equal(digits, nd)
    np.testing.assert_array_equal(signs, ns)
    assert signs[0, 0] == 1 and signs[0, 1] == 1  # 0.0 and -0.0


@pytest.mark.parametrize("p,length,ints", FORMATS)
def test_quantize_packed_matches_jax_and_numpy(jax_lib, monkeypatch, p, length, ints):
    f = values(p, ints, 10 + p)
    mags, signs = native.quantize_packed(f, length, ints, p)
    assert mags.dtype == np.int64 and signs.dtype == np.int64
    jm, js = jax_lib.quantize_packed(f, length, ints, p)
    np.testing.assert_array_equal(mags, jm)
    np.testing.assert_array_equal(signs, js)
    monkeypatch.setattr(native, "_LIB", False)
    nd, ns = radix.float_to_digits_and_sign(f, length, ints, p)
    np.testing.assert_array_equal(mags, radix.pack_digits(nd, p))
    np.testing.assert_array_equal(signs, ns)
    if p in (2, 16):
        nm, ns = marshal.float_matrix_to_mags_and_signs(f.reshape(-1, 2, 2), length, ints, p)
        np.testing.assert_array_equal(mags, nm.reshape(-1))
        np.testing.assert_array_equal(signs, ns.reshape(-1))


@pytest.mark.parametrize("p,length,ints", FORMATS)
def test_dequantize_digits_matches_jax_and_numpy(jax_lib, monkeypatch, p, length, ints):
    rng = np.random.RandomState(20 + p)
    digits = rng.randint(0, p, size=(1500, 3, length))
    digits[0, 0] = p - 1
    signs = rng.choice([-1, 0, 1], size=(1500, 3))
    arr = np.concatenate([digits, signs[..., None]], axis=-1).astype(np.int32)
    got = native.dequantize_digits(arr, length, ints, p)
    assert got.dtype == np.float64 and got.shape == (1500, 3)
    np.testing.assert_array_equal(got, jax_lib.dequantize_digits(arr, length, ints, p))
    monkeypatch.setattr(native, "_LIB", False)
    ref = radix.digits_and_sign_to_float(digits, signs, ints, p)
    if p in (2, 16):
        np.testing.assert_array_equal(got, ref)
    else:  # another summation order: the last bit may differ
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("p,length,ints", FORMATS)
def test_dequantize_packed_matches_jax_and_numpy(jax_lib, monkeypatch, p, length, ints):
    rng = np.random.RandomState(30 + p)
    mags = rng.randint(0, p ** length, size=(1000, 5)).astype(np.int64)
    mags[0, :3] = [0, 1, p ** length - 1]
    signs = rng.choice([-1, 0, 1], size=(1000, 5)).astype(np.int64)
    got = native.dequantize_packed(mags, signs, length, ints, p)
    assert got.dtype == np.float64 and got.shape == (1000, 5)
    np.testing.assert_array_equal(got, jax_lib.dequantize_packed(mags, signs, length, ints, p))
    monkeypatch.setattr(native, "_LIB", False)
    ref = marshal.mags_and_signs_to_float_matrix(mags.reshape(-1, 1), signs.reshape(-1, 1),
                                                 length, ints, p)
    np.testing.assert_array_equal(got.reshape(-1), ref.reshape(-1))


@pytest.mark.parametrize("p,length", [(2, 40), (3, 20), (10, 12), (16, 12)])
def test_pack_digits_matches_jax_and_numpy(jax_lib, p, length):
    digits = np.random.RandomState(40 + p).randint(0, p, size=(2000, 3, length))
    digits[0, 0] = p - 1
    got = native.pack_digits(digits, p)
    assert got.dtype == np.int64 and got.shape == (2000, 3)
    np.testing.assert_array_equal(got, jax_lib.pack_digits(digits, p))
    np.testing.assert_array_equal(got, radix.pack_digits(digits, p))


def test_out_arrays_are_written_and_checked():
    f = values(2, 20, 50, size=4096)
    mags, signs = np.empty(4096, np.int64), np.empty(4096, np.int64)
    got = native.quantize_packed(f, 40, 20, 2, mags, signs)
    assert got[0] is mags and got[1] is signs
    np.testing.assert_array_equal(mags, native.quantize_packed(f, 40, 20, 2)[0])
    with pytest.raises(ValueError, match="C-contiguous int64"):
        native.quantize_packed(f, 40, 20, 2, np.empty(4096, np.int32), signs)
    with pytest.raises(ValueError, match="shape"):
        native.quantize_packed(f, 40, 20, 2, np.empty(4095, np.int64), signs)
    # the converters write into caller arrays on both routes, as int64
    for M in (f.reshape(1024, 2, 2), f[:400].reshape(100, 2, 2)):
        d = np.empty(M.shape[:1] + (4, 40), np.int64)
        s = np.empty(M.shape[:1] + (4,), np.int64)
        out = marshal.float_matrix_to_qfloat_arrays(M, 40, 20, 2, out=(d, s))
        assert out[0] is d and out[1] is s
        want = marshal.float_matrix_to_qfloat_arrays(M, 40, 20, 2)
        np.testing.assert_array_equal(d, want[0])
        np.testing.assert_array_equal(s, want[1])
        m, s = np.empty(M.shape[:1] + (4,), np.int64), np.empty(M.shape[:1] + (4,), np.int64)
        marshal.float_matrix_to_mags_and_signs(M, 40, 20, 2, out=(m, s))
        want = marshal.float_matrix_to_mags_and_signs(M, 40, 20, 2)
        np.testing.assert_array_equal(m, want[0])
        np.testing.assert_array_equal(s, want[1])


CONVERTERS = {
    "float_matrix_to_mags_and_signs": (
        "quantize_packed",
        lambda k: marshal.float_matrix_to_mags_and_signs(values(2, 20, k, size=k).reshape(k, 1, 1),
                                                         40, 20, 2)),
    "float_matrix_to_qfloat_arrays": (
        "quantize_digits",
        lambda k: marshal.float_matrix_to_qfloat_arrays(values(2, 20, k, size=k).reshape(k, 1, 1),
                                                        40, 20, 2)),
    "float_to_digits_and_sign": (
        "quantize_digits",
        lambda k: radix.float_to_digits_and_sign(values(10, 5, k, size=k), 12, 5, 10)),
    "mags_and_signs_to_float_matrix": (
        "dequantize_packed",
        lambda k: marshal.mags_and_signs_to_float_matrix(
            np.arange(k, dtype=np.int64).reshape(k, 1), np.ones((k, 1), np.int64), 40, 20, 2)),
    "qfloat_and_signs_arrays_to_float_matrix": (
        "dequantize_digits",
        lambda k: marshal.qfloat_and_signs_arrays_to_float_matrix(
            np.random.RandomState(k).randint(0, 2, size=(k, 1, 24)).astype(np.int32), 9, 2)),
    "digits_and_sign_to_float": (
        "dequantize_digits",
        lambda k: radix.digits_and_sign_to_float(
            np.random.RandomState(k).randint(0, 3, size=(k, 20)), np.ones(k, np.int64), 8, 3)),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_routing_at_4096_values(monkeypatch, name):
    """4,095 values take numpy, 4,096 the library; the dtypes are the numpy
    route's, and the values agree (within the documented ulp for the digit
    dequantize at base 3)."""
    entry, convert = CONVERTERS[name]
    calls = []
    real = getattr(native, entry)
    monkeypatch.setattr(native, entry, lambda *a, **k: calls.append(1) or real(*a, **k))
    small = convert(4095)
    assert calls == []
    large = convert(4096)
    assert calls == [1]
    monkeypatch.setattr(native, "_LIB", False)
    plain = convert(4096)
    assert calls == [1]
    for got, want, ref in zip(*(x if isinstance(x, tuple) else (x,) for x in (large, plain,
                                                                              small))):
        assert got.dtype == want.dtype == ref.dtype
        assert got.shape == want.shape
        if name == "digits_and_sign_to_float":
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want)


def test_library_builds_once_under_threads(monkeypatch):
    """First use from several threads loads the library once."""
    monkeypatch.setattr(native, "_LIB", None)
    loads = []
    real = native._load
    monkeypatch.setattr(native, "_load", lambda path: loads.append(path) or real(path))
    threads = [threading.Thread(target=native._lib) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(loads) == 1
    assert native._LIB is not None and native._LIB is not False


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / native.SOURCE).write_text("int qmarshal_abi_version( { return 1; }\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed for qmarshal\.cc.*error"):
        native._lib()
    # and a converter routed to the library raises too: no numpy fallback
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        marshal.float_matrix_to_mags_and_signs(np.zeros((4096, 1, 1)), 40, 20, 2)
    assert native._LIB is None


def test_abi_version_is_checked(tmp_path):
    (tmp_path / "v2.cc").write_text('extern "C" int qmarshal_abi_version() { return 2; }\n')
    lib = tmp_path / "libv2.so"
    subprocess.run(["g++", "-shared", "-fPIC", str(tmp_path / "v2.cc"), "-o", str(lib)],
                   check=True)
    with pytest.raises(RuntimeError, match="ABI version 2, expected 1"):
        native._load(lib)


def test_available_matches_jax(jax_lib, monkeypatch, tmp_path):
    """``available()``, as the JAX package's: True where the library loads,
    False where it cannot be had (JAX: no built file; the port: a source that
    does not compile) or the numpy route is forced."""
    assert native.available() is True and jax_lib.available() is True
    monkeypatch.setattr(native, "_LIB", False)
    assert native.available() is False
    src = tmp_path / "csrc"
    src.mkdir()
    (src / native.SOURCE).write_text("int qmarshal_abi_version( { return 1; }\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("QMARSHAL_LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(jax_lib, "_LIB", None)
    monkeypatch.setattr(jax_lib, "_TRIED", False)
    assert native.available() is False and jax_lib.available() is False
