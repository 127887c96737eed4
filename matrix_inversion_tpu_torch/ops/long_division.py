"""The division kernels (K2, K3) and the windowed-multiply kernel (K4).

Replace ``matrix_inversion_tpu/ops/pallas_kernels.py``'s
``_division_float_kernel`` (K2), ``_division_kernel`` (K3) and
``_mul_window_kernel`` (K4), the kernels of the JAX package's op-by-op
path.  The CUDA sources are ``csrc/long_division.cu`` (K2, K3) and
``csrc/mul_window.cu`` (K4: the windowed multiply's partial-product sum in
its algebraic form, one 64-bit product less a 32-bit correction at every
preset's format), on 64-bit words, in the streaming frame they share
(``csrc/stream_frame.cuh``: four elements per thread through 128-bit
streaming accesses).  ``PERF.md`` has their times, bounds and SASS counts.

Each wrapper keeps its JAX contract: int64 inputs broadcast to one shape,
any shape, no padding, the result in the broadcast shape.  A first operand
that is one word (0-dim, or a view broadcast from one element, as a
reciprocal's constant dividend is) is not filled to the batch: the kernels
read it from its one address.  A CUDA tensor launches the kernel; a CPU
tensor runs the plain version (``ops/packed.py``:
:func:`~.packed.packed_long_division_reference` for K2 and K3,
:func:`~.packed.mul_window_sum` masked to the window, the magnitude of
:func:`~.packed.mul_window_packed`, for K4).  Tensors on any other device
are refused.

The two libraries are built with ``nvcc`` at first use (:mod:`.cuda_build`),
keyed by a hash of their sources and the flags.  The parameters (``n_bits``
and ``k``, ``n_digits`` and ``bits``, K4's ``(t1, nt, newlength)``) are
runtime arguments, so the two libraries serve every QFloat format; the
presets' divisions and multiplies have compile-time instances besides.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from .cuda_build import CSRC, NVCC_FLAGS, build_library, library_path, run_parallel
from .packed import mul_window_consts, mul_window_sum, packed_long_division_reference

_SOURCES = {"long_division": "long_division.cu", "mul_window": "mul_window.cu"}


def mul_trunc_format(a_len, a_ints, b_len, b_ints, newlength, newints):
    """K4's ``(t1, nt, newlength)`` for base-2 operands of ``(a_len,
    a_ints)`` and ``(b_len, b_ints)`` digits and a product of ``(newlength,
    newints)``: ``t1`` the digits below the product's window, ``nt`` the
    digits of ``a`` that keep their own floor (``csrc/mul_window.cu``).
    Raises on a format the kernel does not take."""
    for length, ints in ((a_len, a_ints), (b_len, b_ints), (newlength, newints)):
        if not 0 <= ints <= length or not 1 <= length <= 62:
            raise ValueError(f"need 0 <= ints <= len and 1 <= len <= 62, got ({length}, {ints})")
    t1 = (a_len - a_ints) + (b_len - b_ints) - (newlength - newints)
    return t1, max(0, min(t1, a_len)), newlength


def _hashed(name):
    return (tuple((CSRC / f).read_text()
                  for f in ("qfloat_cell.cuh", "stream_frame.cuh", _SOURCES[name]))
            + (" ".join(NVCC_FLAGS),))


def _build_one(name):
    return build_library(_SOURCES[name], f"lib{name}.so", _hashed(name))


def built():
    """Whether both libraries are in ``_build/`` already; builds nothing."""
    return all(library_path(f"lib{name}.so", _hashed(name)).exists() for name in _SOURCES)


def build_dir(name):
    """The build directory of ``"long_division"`` or ``"mul_window"``: the
    library and ``nvcc.log`` with ptxas's registers and spills.  Builds
    first if needed."""
    return _build_one(name).parent


def build():
    """Build both libraries (in parallel, one nvcc each) and load them."""
    run_parallel([functools.partial(_build_one, name) for name in _SOURCES])
    _libraries()


@functools.lru_cache(maxsize=None)
def _libraries():
    with profiling.library("liblong_division.so"):
        div = ctypes.CDLL(str(_build_one("long_division")))
    with profiling.library("libmul_window.so"):
        mul = ctypes.CDLL(str(_build_one("mul_window")))
    fns = {
        "long_division_float": div.long_division_float_launch,
        "long_division_classic": div.long_division_classic_launch,
        "mul_window": mul.mul_window_launch,
    }
    # (x, y, out, n, x_stride, the kernel's parameters, stream)
    for name, params in (("long_division_float", 2), ("long_division_classic", 2),
                         ("mul_window", 3)):
        fns[name].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * (
            1 + params) + [ctypes.c_void_p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def _check(x, y):
    if x.dtype != torch.int64 or y.dtype != torch.int64:
        raise TypeError(f"expected int64 tensors, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on two devices: {x.device} and {y.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected CPU or CUDA tensors, got {x.device}")


def division_operands(dividend, divisor):
    """``(dividend, its element stride, divisor)``: the divisor contiguous in
    the broadcast shape; the dividend likewise with stride 1, or, where it
    is a single word (0-dim, or every axis of size 1 or stride 0), left as
    it is with stride 0.  K4 takes its operands ``(a, b)`` the same way."""
    _check(dividend, divisor)
    shape = torch.broadcast_shapes(dividend.shape, divisor.shape)
    divisor = divisor.expand(shape).contiguous()
    if all(size == 1 or stride == 0 for size, stride in zip(dividend.shape, dividend.stride())):
        return dividend, 0, divisor
    return dividend.expand(shape).contiguous(), 1, divisor


def _launch(name, x, y, *args):
    """One call of kernel ``name``'s launch function over CUDA tensors: ``y``
    contiguous, ``x`` contiguous of the same shape or, with stride 0 first
    in ``args``, a single word; returns the output of ``y``'s shape.  (A
    call of an odd length is two kernels: the pairs, and the last
    element.)  Counts the launch under ``launch.<name>``."""
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    fn = _libraries()[name]
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), y.numel(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    profiling.count("launch." + name)
    return out


def batched_long_division_float(dividend, divisor, n_bits, k):
    """K2: ``dividend // divisor`` by radix-``2**k`` steps from a
    downward-biased f32 reciprocal; a zero divisor gives ``2**n_bits - 1``.
    Exact for ``dividend < 2**n_bits`` and ``divisor < 2**divisor_bits``
    where ``k = _float_div_chunk_bits(n_bits, divisor_bits)``."""
    if not (1 <= n_bits <= 62 and 4 <= k <= 15):
        raise ValueError(f"need n_bits in [1, 62] and k in [4, 15], got {n_bits}, {k}")
    v, v_stride, d = division_operands(dividend, divisor)
    if v.device.type == "cpu":
        return packed_long_division_reference(v, d, n_bits)
    return _launch("long_division_float", v, d, v_stride, n_bits, k)


def batched_long_division(dividend, divisor, n_digits, bits):
    """K3: ``dividend // divisor`` in integers only, through an integer
    reciprocal of the divisor; ``n_digits`` base-``2**bits`` digits fix the
    dividend's width ``n_bits = n_digits * bits`` (bits above it are
    ignored) and nothing else.  A zero divisor gives ``2**n_bits - 1``."""
    if not (1 <= bits <= 16 and 1 <= bits * n_digits <= 62):
        raise ValueError(f"need bits in [1, 16] and bits * n_digits <= 62, got {bits}, {n_digits}")
    v, v_stride, d = division_operands(dividend, divisor)
    if v.device.type == "cpu":
        return packed_long_division_reference(v, d, bits * n_digits)
    return _launch("long_division_classic", v, d, v_stride, n_digits, bits)


def batched_mul_window(a_mag, b_mag, a_len, a_ints, b_len, b_ints, newlength, newints):
    """K4: the base-2 windowed multiply of int64 magnitudes, untracked:
    the cropped partial-product sum of operands of ``(a_len, a_ints)`` and
    ``(b_len, b_ints)`` digits, masked to the product's ``(newlength,
    newints)``."""
    t1, nt, _ = mul_trunc_format(a_len, a_ints, b_len, b_ints, newlength, newints)
    a, a_stride, b = division_operands(a_mag, b_mag)
    if b.device.type == "cpu":
        consts = mul_window_consts(a_len, a_ints, b_len, b_ints, newlength, newints, 1)
        return mul_window_sum(a, b, consts, 1) & ((1 << newlength) - 1)
    return _launch("mul_window", a, b, a_stride, t1, nt, newlength)
