"""The fused whole-inversion kernel (K1): CUDA build, wrapper, plain version.

Replaces ``matrix_inversion_tpu/ops/fused_inverse.py::_fused_kernel``.  The
kernel (``csrc/fused_inverse.cu``) runs the entire batched QFloat inversion,
one thread per matrix, on cells in registers; its body is emitted per
configuration from the circuit by :mod:`.emit`.  Without it the eager
PyTorch circuit makes thousands of passes of batch-sized int64 tensors
through device memory.  The kernel reads and writes the callers'
``(B, n*n)`` layout itself, a block's matrices staged through shared
memory, so a call is one launch and moves its bytes once; a caller that
holds cell-major ``(n*n, B)`` data has :func:`fused_inverse_cell_major`.

:func:`fused_matrix_inverse` keeps the contract of the JAX wrapper:
``(..., n*n)`` int64 magnitudes and signs in, the same out, and with
``track=True`` also an int32 overflow flag per matrix (the tracked
variant, ``ops/fused_inverse.py:186-189`` of the JAX package).  A CUDA
tensor goes through the kernel, and a CPU tensor through the plain version
:func:`fused_matrix_inverse_reference`.

The kernel is built at first use with ``nvcc`` from the sources in
``csrc/`` and the emitted body, into ``_build/<hash>/`` beside this
package (:mod:`.cuda_build`), keyed by a hash of the sources, the emitted
text, the flags and ``track``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.qfloat_lu import qfloat_matrix_inverse_op_by_op
from .cuda_build import CSRC, NVCC_FLAGS, build_library, library_path, run_parallel
from .emit import emit_body
from .packed import plain_arithmetic

FUSED_MAX_N = 12

# Launches of the untracked and of the tracked kernel, for checks that a
# run went through them.
LAUNCHES = 0
TRACKED_LAUNCHES = 0


def _key(config):
    """``(n, len, ints, base, true_division, track)`` from a config tuple
    with or without its trailing ``track`` (default False)."""
    n, qfloat_len, qfloat_ints, qfloat_base, true_division, *track = config
    return (int(n), int(qfloat_len), int(qfloat_ints), int(qfloat_base),
            bool(true_division), bool(track and track[0]))


def build_dir(config, defines=()):
    """The build directory of one config (as for :func:`build`): the
    library, its emitted body, and ``nvcc.log`` with ptxas's registers and
    spills.  Builds first if needed."""
    return _build_one(_key(config), tuple(defines)).parent


def _hashed(key, defines, body):
    """The texts that key the library of one config: the sources, the
    emitted body, the flags, ``track`` and the build switches."""
    return ((CSRC / "qfloat_cell.cuh").read_text(), (CSRC / "fused_inverse.cu").read_text(),
            body, " ".join(NVCC_FLAGS), f"track={key[5]}", *defines)


def built(config, defines=()):
    """Whether the library of one config (as for :func:`build`) is in
    ``_build/`` already; builds nothing."""
    key = _key(config)
    return library_path("libfused_inverse.so", _hashed(key, defines, emit_body(*key))).exists()


def _build_one(key, defines=()):
    """Compile the kernel for one ``(n, len, ints, base, true_division,
    track)``; returns the library path.  Reuses a library already built
    from the same sources, body, flags and ``track``.  ``defines`` are
    ``NAME=value`` macros for the compiler, the build switches of
    ``csrc/qfloat_cell.cuh`` and ``csrc/fused_inverse.cu``: the port builds
    with none, :mod:`..utils.fused_steps` with others, for timing."""
    body = emit_body(*key)
    return build_library(
        "fused_inverse.cu", "libfused_inverse.so", _hashed(key, defines, body),
        files={"fused_body.inc": body},
        what=f"config {key} {' '.join(defines)}",
        flags=tuple(f"-D{d}" for d in defines),
    )


def build(configs):
    """Build (in parallel, one nvcc each) the kernels of ``configs``, each
    a tuple ``(n, qfloat_len, qfloat_ints, qfloat_base, true_division)``
    with an optional trailing ``track``, and load them."""
    keys = [_key(c) for c in configs]
    run_parallel([functools.partial(_build_one, k) for k in keys])
    for k in keys:
        _library(k)


@functools.lru_cache(maxsize=None)
def _library(key, defines=()):
    """``(cell_major, rows)``: the two launch functions of one built
    library.  Both take the four array pointers (five tracked: the flags),
    the batch and the stream; ``rows`` takes the fetch mode before the
    stream (-1: the arrays' own)."""
    lib = ctypes.CDLL(str(_build_one(key, defines)))
    pointers = [ctypes.c_void_p] * (5 if key[5] else 4)
    stem = "fused_inverse_tracked" if key[5] else "fused_inverse"
    cell_major = getattr(lib, f"{stem}_launch")
    cell_major.argtypes = pointers + [ctypes.c_int64, ctypes.c_void_p]
    rows = getattr(lib, f"{stem}_rows_launch")
    rows.argtypes = pointers + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    cell_major.restype = rows.restype = ctypes.c_int
    return cell_major, rows


def block_threads(config):
    """The threads of a block of one config's kernel (the most of 128, 64
    and 32 whose staging buffer fits 48 KB, ``csrc/fused_inverse.cu``), read
    from its library; builds first if needed."""
    fn = ctypes.CDLL(str(_build_one(_key(config)))).fused_inverse_block_threads
    fn.restype = ctypes.c_int
    return fn()


def _check_pair(m, s, what):
    if m.device.type != "cuda" or s.device != m.device:
        raise ValueError(
            f"mags and signs must both be on one CUDA device, got {m.device} and {s.device}"
        )
    if m.dtype != torch.int64 or s.dtype != torch.int64:
        raise TypeError("mags and signs must be int64")
    if m.shape != s.shape:
        raise ValueError(f"mags and signs must both have shape {what}")


def _launch(fn, m, s, batch, track, *mode):
    """Allocate the outputs like ``m``, launch ``fn`` on the current stream
    and count the launch; raises if the launch is refused."""
    om = torch.empty_like(m)
    os_ = torch.empty_like(s)
    ptrs = [m.data_ptr(), s.data_ptr(), om.data_ptr(), os_.data_ptr()]
    if track:
        flag = torch.empty(batch, dtype=torch.int32, device=m.device)
        ptrs.append(flag.data_ptr())
    with torch.cuda.device(m.device):
        err = fn(*ptrs, batch, *mode, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_inverse kernel launch failed: cudaError {err}")
    global LAUNCHES, TRACKED_LAUNCHES
    if track:
        TRACKED_LAUNCHES += 1
        return om, os_, flag
    LAUNCHES += 1
    return om, os_


def fused_matrix_inverse(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base,
                         true_division, track=False):
    """Whole batched inversion: ``(..., n*n)`` int64 magnitudes and signs in,
    the same out (contract of ``matrix_inversion_tpu/ops/fused_inverse.py``
    ``fused_matrix_inverse``).  ``track=True`` returns ``(mags, signs,
    flag)`` with ``flag`` int32 of the batch shape.

    A CUDA tensor launches the kernel, once, on the tensors as they lie:
    the kernel takes the ``(B, n*n)`` layout, any batch size, and storage
    that is 8- but not 16-byte aligned (through 64-bit accesses).  Only an
    input that is not contiguous is copied first (``.contiguous()``).  A CPU
    tensor runs the plain version.
    """
    if not 2 <= n <= FUSED_MAX_N:
        raise ValueError(f"the fused kernel takes n in [2, {FUSED_MAX_N}], got {n}")
    if mags.device.type == "cpu" and signs.device.type == "cpu":
        return fused_matrix_inverse_reference(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division,
            track=track,
        )
    n2 = n * n
    _check_pair(mags, signs, f"(..., {n2})")
    if mags.shape[-1:] != (n2,):
        raise ValueError(f"mags and signs must both have shape (..., {n2})")
    bshape = mags.shape[:-1]
    key = _key((n, qfloat_len, qfloat_ints, qfloat_base, true_division, track))
    out = _launch(_library(key)[1], mags.contiguous(), signs.contiguous(),
                  bshape.numel(), track, -1)
    if track:
        return out[0], out[1], out[2].reshape(bshape)
    return out


def fused_inverse_cell_major(cm, cs, n, qfloat_len, qfloat_ints, qfloat_base,
                             true_division, track=False):
    """One kernel launch on cell-major ``(n*n, B)`` contiguous int64 CUDA
    tensors; returns the ``(n*n, B)`` output magnitudes and signs, and with
    ``track=True`` also the ``(B,)`` int32 overflow flags."""
    _check_pair(cm, cs, f"({n * n}, B)")
    if not (cm.is_contiguous() and cs.is_contiguous()):
        raise ValueError("cell-major inputs must be contiguous")
    if cm.dim() != 2 or cm.shape[0] != n * n:
        raise ValueError(f"cell-major inputs must both have shape ({n * n}, B)")
    key = _key((n, qfloat_len, qfloat_ints, qfloat_base, true_division, track))
    return _launch(_library(key)[0], cm, cs, cm.shape[1], track)


def fused_matrix_inverse_reference(mags, signs, n, qfloat_len, qfloat_ints,
                                   qfloat_base, true_division, track=False):
    """Plain version of the kernel: the circuit run eagerly, op by op, on
    int64 :class:`~.packed.PackedQFloat` cells, on any device, with every
    division and multiply in plain PyTorch (the division and multiply
    kernels switched off for the call).  ``track=True`` runs it inside
    ``track_overflow()`` and also returns the combined flags, int32 of the
    batch shape."""
    with plain_arithmetic():
        return qfloat_matrix_inverse_op_by_op(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division,
            track=track,
        )
