"""The limb backend's kernels: K6, the long division of digit arrays, and K7,
their carry chain with its sign and magnitude.

They have no Pallas counterpart: they replace the ``lax.scan`` chains of
``matrix_inversion_tpu/ops/limbs.py`` (``base_p_division``, ``:195``;
``base_tidy`` and ``tidy_to_sign_mag``, ``:231``), which JAX compiles into
one program and eager PyTorch would run as a few launches a digit.  The
CUDA sources are ``csrc/limb_division.cu`` and ``csrc/limb_tidy.cu`` in the
frame of ``csrc/limb_frame.cuh``: one thread a number, a block's 128
numbers staged through shared memory, their int32 digits (most significant
first, batch-major ``(N, L)``) read and written as contiguous runs.  K6
divides with its remainder window in 64-bit words; K7 walks the digits from
the least significant up.  ``PERF.md`` has their times and bounds.

Each wrapper takes int32 digit tensors on one CUDA device, with leading
batch axes, broadcasts their batches, launches the kernel on the current
stream and gives the result in the broadcast batch shape; it raises if the
launch fails, and on tensors anywhere else: ``ops/limbs.py`` alone decides
which tensors take the kernels and which the plain versions.  The base and
the widths are runtime arguments, so one library of each serves every
encoding; K6 keeps its window in up to :data:`MAX_WORDS` words in
registers, for rows of up to :data:`MAX_STAGED_DIGITS` digits, and a digit
window in a global scratch tensor that the wrapper allocates past that.
Both libraries are built with ``nvcc`` at first use (:mod:`.cuda_build`),
keyed by a hash of their sources and the flags.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from .cuda_build import CSRC, NVCC_FLAGS, build_library, run_parallel

# K6's widest window in words (csrc/limb_division.cu, kMaxWords) and its
# widest staged row (kMaxStagedDigits); past either, a division takes the
# form with a digit window in global scratch, limb_division_wide.
MAX_WORDS = 8
MAX_STAGED_DIGITS = 449

# K6 built as it was designed first, one thread a number with its window a
# row of digits in registers (csrc/limb_division.cu, LIMB_DIGIT_WINDOW), to
# time against the word window; its window takes divisors of up to
# DIGIT_WINDOW_DIGITS digits
DIGIT_WINDOW = ("-DLIMB_DIGIT_WINDOW",)
DIGIT_WINDOW_DIGITS = 256


@functools.lru_cache(maxsize=None)
def window_plan(base, v_len):
    """``(chunk, words)`` of K6 at a base and a divisor width
    (csrc/limb_division.cu, radix_of): the quotient digits it finds at
    once, at most the most with ``base**k < 2**32``, and its window's
    64-bit words, the fewest that hold ``base**(v_len + chunk) - 1``.  The
    chunk is the most unless those digits take the window past one digit's
    words while half of them or more fit there; then as many as fit."""
    most = 1
    while base ** (most + 1) < 2 ** 32:
        most += 1

    def words(digits):
        return -(-((base ** digits - 1).bit_length()) // 64)

    fit = 1
    while fit < most and words(v_len + fit + 1) <= words(v_len + 1):
        fit += 1
    chunk = most if 2 * fit < most else fit
    return chunk, words(v_len + chunk)


def window_words(base, v_len):
    """K6's window in 64-bit words (:func:`window_plan`)."""
    return window_plan(base, v_len)[1]


def scratch_form(d_len, v_len, base, flags=()):
    """Whether K6 (built with ``flags``) divides at these widths in its form
    with the window in global scratch."""
    if flags == DIGIT_WINDOW:
        return v_len > DIGIT_WINDOW_DIGITS
    return (max(d_len, v_len) > MAX_STAGED_DIGITS
            or window_words(base, v_len) > MAX_WORDS)


def staged_bytes(d_len, v_len, base, one_row=False):
    """Bytes of shared memory a block of K6's staged kernel takes: 128 rows
    of an odd number of 32-bit words, each holding ``max(d_len, v_len)``
    digits in 16 bits (in 32 at bases past ``2**16``), and a reciprocal's
    row of int32 (csrc/limb_division.cu, staged_bytes)."""
    slot = 2 if base <= 1 << 16 else 4
    words = -(-max(d_len, v_len) * slot // 4) | 1
    return 4 * (128 * words + (d_len if one_row else 0))


_ARGTYPES = {
    # (v, v_stride, d, q, n, d_len, v_len, base, stream)
    "limb_division": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p],
    # (v, v_stride, d, q, window, n, d_len, v_len, base, stream)
    "limb_division_wide": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p],
    # (in, out, sign or NULL, n, len, base, stream)
    "limb_tidy": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p],
}


def _build_one(name, flags=()):
    source = f"{name}.cu"
    return build_library(
        source, f"lib{name}.so",
        tuple((CSRC / f).read_text() for f in ("limb_frame.cuh", source))
        + (" ".join(NVCC_FLAGS + flags),),
        flags=flags,
    )


def build_dir(name, flags=()):
    """The build directory of ``"limb_division"`` or ``"limb_tidy"`` (with
    ``-D`` switches ``flags``): the library and ``nvcc.log`` with ptxas's
    registers and spills.  Builds first if needed."""
    return _build_one(name, flags).parent


def build():
    """Build both libraries and K6's :data:`DIGIT_WINDOW` form (in
    parallel, one nvcc each) and load them."""
    jobs = [("limb_division", ()), ("limb_tidy", ()), ("limb_division", DIGIT_WINDOW)]
    run_parallel([functools.partial(_build_one, *job) for job in jobs])
    for job in jobs:
        _library(*job)


@functools.lru_cache(maxsize=None)
def _library(name, flags=(), entry=None):
    """The launch function ``<entry>_launch`` (``entry`` defaults to
    ``name``) of library ``name`` built with ``flags``."""
    entry = entry or name
    with profiling.library(f"lib{name}.so"):
        fn = getattr(ctypes.CDLL(str(_build_one(name, flags))), f"{entry}_launch")
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def _check_digits(base, *tensors):
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 digit tensors, got {t.dtype}")
        if t.dim() < 1 or t.shape[-1] < 1:
            raise ValueError(f"expected digit tensors with a digit axis, got {tuple(t.shape)}")
    if base < 2:
        raise ValueError(f"base must be >= 2, got {base}")


def _check_device(*tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on two devices: {sorted(map(str, devices))}")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {tensors[0].device}: the plain "
                         "versions are in ops/limbs.py")


def _launch(name, *args, device, flags=(), entry=None):
    """One launch of ``entry`` of library ``name``, counted under
    ``launch.<name>``."""
    fn = _library(name, flags, entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    profiling.count("launch." + name)


def limb_division(dividend, divisor, base, flags=()):
    """K6: the long division of tidy digit arrays (each digit in ``[0,
    base)``): ``(..., d_len)`` dividends by ``(..., v_len)`` divisors,
    ``(..., d_len)`` int32 quotient digits, all ``base - 1`` where the
    divisor is zero.  A dividend broadcast over the batch (a reciprocal's
    constant) is read from one row.  ``flags``: the build to launch
    (:data:`DIGIT_WINDOW`, to time it).
    Where :func:`scratch_form` says so, the division takes the form whose
    window is a scratch tensor of ``N * (v_len + 1)`` int32, allocated here
    for the call."""
    _check_digits(base, dividend, divisor)
    d_len, v_len = dividend.shape[-1], divisor.shape[-1]
    _check_device(dividend, divisor)
    batch = torch.broadcast_shapes(dividend.shape[:-1], divisor.shape[:-1])
    q = torch.empty(batch + (d_len,), dtype=torch.int32, device=divisor.device)
    if q.numel() == 0:
        return q
    d = divisor.expand(batch + (v_len,)).contiguous()
    lead = dividend.shape[:-1]
    if all(size == 1 or stride == 0 for size, stride in zip(lead, dividend.stride()[:-1])):
        v, v_stride = dividend[(0,) * len(lead)].contiguous(), 0
    else:
        v, v_stride = dividend.expand(batch + (d_len,)).contiguous(), d_len
    n = q.numel() // d_len
    if not scratch_form(d_len, v_len, base, flags):
        _launch("limb_division", v.data_ptr(), v_stride, d.data_ptr(), q.data_ptr(),
                n, d_len, v_len, base, device=d.device, flags=flags)
        return q
    window = torch.empty(n * (v_len + 1), dtype=torch.int32, device=d.device)
    _launch("limb_division", v.data_ptr(), v_stride, d.data_ptr(), q.data_ptr(),
            window.data_ptr(), n, d_len, v_len, base, device=d.device, flags=flags,
            entry="limb_division_wide")
    return q


def limb_tidy(arr, base, signed=False):
    """K7: the signed carry chain of ``(..., L)`` int32 digit arrays, digits
    into ``]-base, base[`` and the carry past the top dropped; with
    ``signed=True`` then the magnitude and the sign of the tidied value
    (``tidy_to_sign_mag``): ``(digits, int32 sign)``, sign +1 for a value
    >= 0."""
    _check_digits(base, arr)
    _check_device(arr)
    a = arr.contiguous()
    length = a.shape[-1]
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    sign = torch.empty(a.shape[:-1], dtype=torch.int32, device=a.device) if signed else None
    if out.numel():
        _launch("limb_tidy", a.data_ptr(), out.data_ptr(),
                sign.data_ptr() if signed else None, out.numel() // length, length, base,
                device=a.device)
    return (out, sign) if signed else out
