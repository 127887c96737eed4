"""ctypes bindings for the port's native marshalling library (csrc/qmarshal.cc).

Port of ``matrix_inversion_tpu/runtime/native.py:19-108``: the same five
entry points and the same ABI check, on the port's own copy of the source.
The library is built at first use with g++ (``ops/cuda_build.py``,
``HOST_FLAGS``) into ``_build/<hash>/`` and loaded once per process.  A
failed build raises with the compiler's output: the port needs g++ on every
machine it runs on, so it has no quiet numpy fallback for a missing build,
as the JAX package has (``native.py:28-35``).

The numpy closed form (``ops/radix.py``, ``models/marshal.py``) stays as the
plain version: the converters take it below ``NATIVE_MIN_VALUES`` values and
this library at or above, as the JAX package does
(``matrix_inversion_tpu/ops/radix.py:97,116``,
``matrix_inversion_tpu/models/marshal.py:122-125,200-206``).  ctypes
releases the GIL for each call, and the library spreads a call over the
host's cores, so the streaming pipeline's threads convert in parallel.

Every entry point may write into caller-owned arrays (``out``), such as the
numpy views of pinned host tensors that the stream copies from; their shape,
dtype and contiguity are checked before a pointer is passed.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import cuda_build
from ..utils import profiling

NATIVE_MIN_VALUES = 4096
ABI_VERSION = 1
SOURCE = "qmarshal.cc"

# The loaded library, None until first use.  ``False`` sends every
# conversion down the numpy route: ``utils/run_benchmarks.py::e2e`` sets it
# for its numpy leg, as the JAX benchmark swaps the JAX module's handle.
_LIB = None
_LOCK = threading.Lock()


def build():
    """Compile ``csrc/qmarshal.cc`` with g++ (or reuse the build of the same
    text and flags) and return the library's path; raises on failure."""
    text = (cuda_build.CSRC / SOURCE).read_text()
    return cuda_build.build_library(
        SOURCE, "libqmarshal.so", (text, " ".join(cuda_build.HOST_FLAGS)),
        what="(the host marshaller)", host=True,
    )


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.qmarshal_abi_version.argtypes = []
    lib.qmarshal_abi_version.restype = ctypes.c_int32
    version = lib.qmarshal_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"{path}: qmarshal ABI version {version}, expected {ABI_VERSION}")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c32, c64 = ctypes.c_int32, ctypes.c_int64
    lib.quantize_digits.argtypes = [f64p, c64, c32, c32, c32, i32p, i32p]
    lib.quantize_packed.argtypes = [f64p, c64, c32, c32, c32, i64p, i64p]
    lib.dequantize_digits.argtypes = [i32p, c64, c32, c32, c32, f64p]
    lib.dequantize_packed.argtypes = [i64p, i64p, c64, c32, c32, c32, f64p]
    lib.pack_digits.argtypes = [i32p, c64, c32, c32, i64p]
    for name in ("quantize_digits", "quantize_packed", "dequantize_digits",
                 "dequantize_packed", "pack_digits"):
        getattr(lib, name).restype = None
    return lib


def _lib():
    """The library, built and loaded on the first call (one thread builds,
    the others wait)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            with profiling.library("libqmarshal.so"):
                _LIB = _load(build())
        return _LIB


def available() -> bool:
    """Whether the conversions can take this library (the JAX package's
    ``runtime/native.py::available``): it builds and loads, and the numpy
    route is not forced."""
    if _LIB is False:
        return False
    try:
        return _lib() is not None
    except (RuntimeError, OSError):
        return False


def routed(n_values: int) -> bool:
    """Whether a host conversion of ``n_values`` values takes this library:
    at ``NATIVE_MIN_VALUES`` or more, unless the numpy route is forced."""
    return n_values >= NATIVE_MIN_VALUES and _LIB is not False


def _out(out, shape, dtype):
    """``out`` checked against ``shape`` and ``dtype`` (C-contiguous), or a
    new array."""
    if out is None:
        return np.empty(shape, dtype=dtype)
    if out.shape != shape or out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    return out


def quantize_digits(values, length, ints, base, digits=None, signs=None):
    """float64 array (any shape) -> (digits int32[..., length], signs int32[...])."""
    values = np.ascontiguousarray(values, dtype=np.float64)
    digits = _out(digits, values.shape + (length,), np.int32)
    signs = _out(signs, values.shape, np.int32)
    _lib().quantize_digits(values.reshape(-1), values.size, length, ints, base,
                           digits.reshape(-1, length), signs.reshape(-1))
    return digits, signs


def quantize_packed(values, length, ints, base, mags=None, signs=None):
    """float64 array -> (mags int64[...], signs int64[...])."""
    values = np.ascontiguousarray(values, dtype=np.float64)
    mags = _out(mags, values.shape, np.int64)
    signs = _out(signs, values.shape, np.int64)
    _lib().quantize_packed(values.reshape(-1), values.size, length, ints, base,
                           mags.reshape(-1), signs.reshape(-1))
    return mags, signs


def dequantize_digits(digits_and_sign, length, ints, base, out=None):
    """(..., length+1) int32 digit+sign arrays -> float64 values."""
    arr = np.ascontiguousarray(digits_and_sign, dtype=np.int32)
    if arr.shape[-1] != length + 1:
        raise ValueError(f"expected (..., {length + 1}) digits and sign, got {arr.shape}")
    out = _out(out, arr.shape[:-1], np.float64)
    _lib().dequantize_digits(arr.reshape(-1, length + 1), out.size, length, ints, base,
                             out.reshape(-1))
    return out


def dequantize_packed(mags, signs, length, ints, base, out=None):
    """int64 magnitudes and signs -> float64 values."""
    mags = np.ascontiguousarray(mags, dtype=np.int64)
    signs = np.ascontiguousarray(signs, dtype=np.int64)
    if signs.shape != mags.shape:
        raise ValueError(f"mags {mags.shape} and signs {signs.shape} differ in shape")
    out = _out(out, mags.shape, np.float64)
    _lib().dequantize_packed(mags.reshape(-1), signs.reshape(-1), mags.size, length, ints,
                             base, out.reshape(-1))
    return out


def pack_digits(digits, base, out=None):
    """int32 digit arrays (..., length) -> int64 magnitudes."""
    digits = np.ascontiguousarray(digits, dtype=np.int32)
    length = digits.shape[-1]
    out = _out(out, digits.shape[:-1], np.int64)
    _lib().pack_digits(digits.reshape(-1, length), out.size, length, base, out.reshape(-1))
    return out
