"""The float stream's packed quantize and dequantize on the card: float64
values to int64 magnitudes and signs, and back.

They have no Pallas counterpart: the JAX package converts on the host
(``matrix_inversion_tpu/native/qmarshal.cc``), and so does the port's host
route (``csrc/qmarshal.cc::quantize_packed`` and ``::dequantize_packed``,
``runtime/native.py``).  The CUDA source is ``csrc/float_io.cu``: two
elementwise kernels that give the host route's bits for every float64, two
values a thread in 16-byte accesses.  ``runtime/stream.py`` launches them
around ``run_raw`` for a packed-I/O stream on a card, so that a batch crosses
PCIe as float64.  ``PERF.md`` has their times and bounds.

The launch functions take CUDA tensors only and raise on anything else; the
plain versions (:func:`quantize_reference`, :func:`dequantize_reference`) are
eager PyTorch for any device.  The format (``length``, ``ints``, the base)
is a run-time argument, so one library serves every packed format.  It is
built with ``nvcc`` at first use (:mod:`.cuda_build`), keyed by a hash of its
source and the flags, and loaded on the first CUDA call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import profiling
from .cuda_build import CSRC, NVCC_FLAGS, build_library

SOURCE = "float_io.cu"
# no contraction into an FMA: the dequantize's two products round as the
# host's do
FLAGS = ("--fmad=false",)

_ARGTYPES = {
    # (values, mags, signs, count, len, ints, bits, stream)
    "float_quantize": [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p],
    # (mags, signs, out, count, scale, stream)
    "float_dequantize": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_double,
                                                 ctypes.c_void_p],
}


def _build():
    return build_library(SOURCE, "libfloat_io.so",
                         ((CSRC / SOURCE).read_text(), " ".join(NVCC_FLAGS + FLAGS)),
                         flags=FLAGS)


def build_dir():
    """The library's build directory (the library and ``nvcc.log`` with
    ptxas's registers and spills).  Builds first if needed."""
    return _build().parent


@functools.lru_cache(maxsize=None)
def _library(entry):
    """The launch function ``<entry>_launch``."""
    with profiling.library("libfloat_io.so"):
        fn = getattr(ctypes.CDLL(str(_build())), f"{entry}_launch")
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry, *args, device):
    """One launch of ``entry`` on ``device``'s current stream, counted under
    ``launch.<entry>``; raises if the launch is refused."""
    fn = _library(entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    profiling.count("launch." + entry)


def _check_device(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}: the plain versions are "
                         "quantize_reference and dequantize_reference")


def _check(t, dtype, what):
    _check_device(t, what)
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def format_bits(length, ints, base):
    """``log2(base)`` of a packed format, checked: a power-of-two base, ``0
    <= ints <= length`` and ``bits * length <= 62``."""
    if base < 2 or base & (base - 1):
        raise ValueError(f"the packed quantize needs a power-of-two base, got {base}")
    bits = base.bit_length() - 1
    if not 0 <= ints <= length or bits * length > 62:
        raise ValueError(f"format ({length}, {ints}) at base {base}: need 0 <= ints <= length "
                         "and log2(base) * length <= 62")
    return bits


def dequantize_scale(length, ints, base):
    """``base ** -(length - ints)`` as ``csrc/qmarshal.cc`` computes it (C's
    ``pow``)."""
    return math.pow(float(base), -float(length - ints))


def quantize(values, length, ints, base):
    """Contiguous float64 values (any shape) on a card -> ``(mags, signs)``,
    int64 tensors of their shape: ``csrc/qmarshal.cc::quantize_packed`` bit
    for bit, in one launch of ``float_quantize_kernel`` (none for an empty
    batch)."""
    _check(values, torch.float64, "values")
    bits = format_bits(length, ints, base)
    mags = torch.empty(values.shape, dtype=torch.int64, device=values.device)
    signs = torch.empty_like(mags)
    if values.numel():
        _launch("float_quantize", values.data_ptr(), mags.data_ptr(), signs.data_ptr(),
                values.numel(), length, ints, bits, device=values.device)
    return mags, signs


def dequantize(mags, signs, length, ints, base):
    """Contiguous int64 magnitudes and signs of one shape on a card ->
    float64 values ``mag * base**-(length - ints) * sign``:
    ``csrc/qmarshal.cc::dequantize_packed`` bit for bit, in one launch of
    ``float_dequantize_kernel`` (none for an empty batch)."""
    _check(mags, torch.int64, "mags")
    _check(signs, torch.int64, "signs")
    if signs.shape != mags.shape or signs.device != mags.device:
        raise ValueError(f"signs {tuple(signs.shape)} on {signs.device} for mags "
                         f"{tuple(mags.shape)} on {mags.device}")
    out = torch.empty(mags.shape, dtype=torch.float64, device=mags.device)
    if mags.numel():
        _launch("float_dequantize", mags.data_ptr(), signs.data_ptr(), out.data_ptr(),
                mags.numel(), dequantize_scale(length, ints, base), device=mags.device)
    return out


_INT64_MIN = -(2 ** 63)


def _to_int64(x):
    """x86-64's conversion of float64 to int64, which the host route's
    ``static_cast`` compiles to: toward zero, and ``-2**63`` for a value out
    of range or a NaN."""
    fits = (x >= -2.0 ** 63) & (x < 2.0 ** 63)
    return torch.where(fits, torch.where(fits, x, 0.0).to(torch.int64), _INT64_MIN)


def quantize_reference(values, length, ints, base):
    """The plain version of :func:`quantize`, for float64 values on any
    device."""
    bits = format_bits(length, ints, base)
    fp_bits = bits * (length - ints)
    af = torch.where(values < 0, -values, values)
    int_part = torch.trunc(af)
    int_mag = _to_int64(int_part) & ((1 << (bits * ints)) - 1)
    frac_mag = _to_int64((af - int_part) * float(2 ** fp_bits))
    signs = torch.where(values < 0, -1, 1).to(torch.int64)
    return (int_mag << fp_bits) | frac_mag, signs


def dequantize_reference(mags, signs, length, ints, base):
    """The plain version of :func:`dequantize`, on any device."""
    scale = dequantize_scale(length, ints, base)
    return mags.to(torch.float64) * scale * signs.to(torch.float64)
