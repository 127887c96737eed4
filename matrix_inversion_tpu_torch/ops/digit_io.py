"""The digit-I/O kernels: the pack of int64 digit rows into magnitudes and the
unpack of magnitudes (and signs) into int32 digit rows.

They have no Pallas counterpart: they replace the ``jnp`` pack and unpack of
``matrix_inversion_tpu/models/inverse.py:61-105``, which XLA fuses into one
pass each and eager PyTorch would run as three and four launches that move
each byte several times.  The CUDA source is ``csrc/digit_io.cu``: a block
stages a tile of 128 cells through shared memory, so that each byte moves
once, in 16-byte accesses.  ``PERF.md`` has their times and bounds.

The launch functions take CUDA tensors only and raise on anything else:
``ops/packed.py``'s :func:`~.packed.digits_to_mags` and
:func:`~.packed.mags_to_digits` decide which tensors take them and which the
plain versions.  ``bits`` and the row length are runtime arguments, so one
library serves every format.  It is built with ``nvcc`` at first use
(:mod:`.cuda_build`), keyed by a hash of its source and the flags, and
loaded on the first CUDA call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from .cuda_build import CSRC, NVCC_FLAGS, build_library

SOURCE = "digit_io.cu"

_ARGTYPES = {
    # (digits, mags, cells, len, bits, stream)
    "digits_pack": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p],
    # (mags, signs or NULL, out, cells, len, row_stride, bits, stream)
    "digits_unpack": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                                              ctypes.c_int, ctypes.c_void_p],
}


def _build():
    return build_library(SOURCE, "libdigit_io.so",
                         ((CSRC / SOURCE).read_text(), " ".join(NVCC_FLAGS)))


def build_dir():
    """The library's build directory (the library and ``nvcc.log`` with
    ptxas's registers and spills).  Builds first if needed."""
    return _build().parent


@functools.lru_cache(maxsize=None)
def _library(entry):
    """The launch function ``<entry>_launch``."""
    with profiling.library("libdigit_io.so"):
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
                         "in ops/packed.py")


def _check(t, dtype, what):
    _check_device(t, what)
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_bits(bits):
    if not 1 <= bits <= 63:
        raise ValueError(f"bits must be in 1..63, got {bits}")


def pack(digits, bits):
    """``(..., L)`` contiguous int64 digits on a card -> ``(...)`` int64
    magnitudes ``sum_j digit_j << bits*(L-1-j)`` mod 2**64, in one launch of
    ``digits_pack_kernel`` (none for an empty batch)."""
    _check(digits, torch.int64, "digits")
    _check_bits(bits)
    length = digits.shape[-1]
    if length < 1:
        raise ValueError(f"digits need a digit axis of 1 or more, got {tuple(digits.shape)}")
    mags = torch.empty(digits.shape[:-1], dtype=torch.int64, device=digits.device)
    if mags.numel():
        _launch("digits_pack", digits.data_ptr(), mags.data_ptr(), mags.numel(), length, bits,
                device=digits.device)
    return mags


def unpack(mags, out, bits, signs=None):
    """``(...)`` contiguous int64 magnitudes on a card into ``out``, int32
    ``(..., W)`` with rows a uniform stride apart and a unit last stride:
    the ``L`` digits ``(mag >> bits*(L-1-j)) & (2**bits - 1)``, ``L = W``,
    or with ``signs`` (contiguous int64 of ``mags``' shape) ``L = W - 1``
    and the sign in column ``L``; in one launch of ``digits_unpack_kernel``
    (none for an empty batch).  Returns ``out``."""
    _check(mags, torch.int64, "mags")
    _check_bits(bits)
    if signs is not None:
        _check(signs, torch.int64, "signs")
        if signs.shape != mags.shape or signs.device != mags.device:
            raise ValueError(f"signs {tuple(signs.shape)} on {signs.device} for mags "
                             f"{tuple(mags.shape)} on {mags.device}")
    if out.device != mags.device or out.dtype != torch.int32:
        raise ValueError(f"out must be int32 on {mags.device}, got {out.dtype} on {out.device}")
    if out.shape[:-1] != mags.shape:
        raise ValueError(f"out {tuple(out.shape)} does not fit mags {tuple(mags.shape)}")
    width = out.shape[-1]
    length = width - (signs is not None)
    if length < 1:
        raise ValueError(f"out {tuple(out.shape)} has no digit column")
    if not mags.numel():
        return out
    row_stride = row_stride_of(out)
    if row_stride is None or row_stride < width:
        raise ValueError(f"out {tuple(out.shape)}, strides {out.stride()}: need a unit stride "
                         "along the digits and rows a uniform stride apart")
    _launch("digits_unpack", mags.data_ptr(), None if signs is None else signs.data_ptr(),
            out.data_ptr(), mags.numel(), length, row_stride, bits, device=mags.device)
    return out


def row_stride_of(t):
    """The distance in elements between consecutive rows (the last axis) of
    ``t``, taken in order over its leading axes, where the last axis has a
    unit stride and that distance is the same throughout; else None.  A
    tensor of one row gives its row's length."""
    if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    stride = expected = None
    for size, step in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        if size == 1:
            continue
        if expected is not None and step != expected:
            return None
        stride = step if stride is None else stride
        expected = step * size
    return t.shape[-1] if stride is None else stride
