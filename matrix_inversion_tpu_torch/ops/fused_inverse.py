"""The fused whole-inversion kernel (K1): CUDA builds, wrapper, plain version.

Replaces ``matrix_inversion_tpu/ops/fused_inverse.py::_fused_kernel``.  The
kernel runs the entire batched QFloat inversion in one launch; without it
the eager PyTorch circuit makes thousands of passes of batch-sized int64
tensors through device memory.  It has two designs, one library per
configuration each:

- the straight-line design (``csrc/fused_inverse.cu``), for n below
  :data:`LANES_MIN_N` (tracked: :data:`LANES_MIN_N_TRACKED`): one thread a
  matrix, every cell in registers, the body emitted per configuration from
  the circuit by :mod:`.emit`.  At n = 2 that body is the closed form
  adj(M)/det(M), and each launch there adds its B matrices to
  ``k1.closed_form_matrices``.  The body grows as n^3 and spills past
  n = 5, so from there on it is built only to be timed beside the other
  (up to ``STRAIGHT_LINE_MAX_N``);
- the lanes design (``csrc/fused_inverse_lanes.cu``), from
  :data:`LANES_MIN_N`, any n as JAX's kernel: a group of n lanes a matrix,
  floor(32/n) groups a warp, one row a lane, the matrix and L/U in shared
  memory, the circuit in loops over compile-time bounds, the configuration
  in ``-D`` macros.  Each launch adds the lanes its matrices fill (B*n) to
  ``lanes.matrix_lanes`` and the lanes it launches to
  ``lanes.launched_lanes`` (``utils/profiling.py``).

Both read and write the callers' ``(B, n*n)`` layout themselves, a
block's matrices staged through shared memory, so a call is one launch
and moves its bytes once; each library has one entry, that layout's.  Both
give the circuit's bits.

:func:`fused_matrix_inverse` keeps the contract of the JAX wrapper:
``(..., n*n)`` int64 magnitudes and signs in, the same out, any n >= 2,
and with ``track=True`` also an int32 overflow flag per matrix (the tracked
variant, ``ops/fused_inverse.py:186-189`` of the JAX package).  A CUDA
tensor goes through the kernel of its n's design, and a CPU tensor through
the plain version :func:`fused_matrix_inverse_reference`.  ``FUSED_MAX_N``
is JAX's value: it bounds only ``lowering="auto"``'s choice of this kernel
(``models/inverse.py``), not what the kernel takes.

The kernels are built at first use with ``nvcc`` from the sources in
``csrc/`` (and, straight-line, the emitted body) into ``_build/<hash>/``
beside this package (:mod:`.cuda_build`), keyed by a hash of the sources,
the emitted text, the flags and ``track``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.qfloat_lu import qfloat_matrix_inverse_op_by_op
from ..utils import profiling
from .cuda_build import CSRC, NVCC_FLAGS, build_library, library_path, run_parallel
from .emit import emit_body
from .packed import digit_bits, plain_arithmetic

FUSED_MAX_N = 12
# The smallest n that the lanes design serves, untracked and tracked; below
# it the straight-line design does.  Set from the two designs timed in turns
# on the card (chip_smoke.py's k1_design_turns, PERF.md): at n = 6 the untracked
# designs tie, the tracked lanes design is faster; from n = 7 it is in both.
LANES_MIN_N = 7
LANES_MIN_N_TRACKED = 6
DESIGNS = ("straight_line", "lanes")
# The largest n the straight-line design is built at, for timing beside the
# lanes design: its nvcc takes minutes there (3-8 at n = 12) and grows as n^3.
STRAIGHT_LINE_MAX_N = 12


def _key(config):
    """``(n, len, ints, base, true_division, track)`` from a config tuple
    with or without its trailing ``track`` (default False)."""
    n, qfloat_len, qfloat_ints, qfloat_base, true_division, *track = config
    return (int(n), int(qfloat_len), int(qfloat_ints), int(qfloat_base),
            bool(true_division), bool(track and track[0]))


def design_of(n, track=False):
    """The design that serves n on the card: "lanes" from
    :data:`LANES_MIN_N` (tracked :data:`LANES_MIN_N_TRACKED`), else
    "straight_line"."""
    return "lanes" if n >= (LANES_MIN_N_TRACKED if track else LANES_MIN_N) else "straight_line"


def _design(key, design):
    """``design``, or the one that serves the key's n; raises for a name
    that is not a design and for the lanes design at n = 2, which is the
    closed form."""
    design = design_of(key[0], key[5]) if design is None else design
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: expected one of {DESIGNS}")
    if design == "lanes" and key[0] < 3:
        raise ValueError(f"the lanes design takes n >= 3, got {key[0]}")
    return design


def build_dir(config, design=None):
    """The build directory of one config (as for :func:`build`): the
    library, the straight-line design's emitted body, and ``nvcc.log`` with
    ptxas's registers and spills.  Builds first if needed."""
    key = _key(config)
    return _build_one(key, _design(key, design)).parent


def _hashed(key, body):
    """The texts that key the straight-line library of one config: the
    sources, the emitted body, the flags and ``track``."""
    return ((CSRC / "qfloat_cell.cuh").read_text(), (CSRC / "fused_inverse.cu").read_text(),
            body, " ".join(NVCC_FLAGS), f"track={key[5]}")


def lanes_defines(key):
    """The ``-D`` macros that make ``csrc/fused_inverse_lanes.cu`` one
    configuration's kernel."""
    n, qfloat_len, qfloat_ints, qfloat_base, true_division, track = key
    bits = digit_bits(qfloat_base)
    if bits * qfloat_len > 62:
        raise ValueError("encoding too wide for the packed backend")
    return (f"LANES_N={n}", f"LANES_BITS={bits}", f"LANES_LEN={qfloat_len}",
            f"LANES_INTS={qfloat_ints}", f"LANES_TRUE_DIV={int(true_division)}",
            f"LANES_TRACK={int(track)}")


def _lanes_hashed(key):
    return ((CSRC / "qfloat_cell.cuh").read_text(),
            (CSRC / "fused_inverse_lanes.cu").read_text(), " ".join(NVCC_FLAGS),
            *lanes_defines(key))


_LIB_NAMES = {"straight_line": "libfused_inverse.so", "lanes": "libfused_inverse_lanes.so"}
# the launch counter of each design, untracked and tracked (``utils/profiling.py``)
_COUNTERS = {(d, t): f"launch.fused_inverse{'_lanes' * (d == 'lanes')}{'_tracked' * t}"
             for d in DESIGNS for t in (False, True)}


def built(config, design=None):
    """Whether the library of one config (as for :func:`build`) is in
    ``_build/`` already; builds nothing."""
    key = _key(config)
    design = _design(key, design)
    hashed = _lanes_hashed(key) if design == "lanes" else _hashed(key, emit_body(*key))
    return library_path(_LIB_NAMES[design], hashed).exists()


def _build_one(key, design="straight_line"):
    """Compile one design's kernel for one ``(n, len, ints, base,
    true_division, track)``; returns the library path.  Reuses a library
    already built from the same sources, body, flags and ``track``.  The
    emitter and the hash count in ``library.ns``."""
    with profiling.library(_LIB_NAMES[design]):
        if design == "lanes":
            return build_library(
                "fused_inverse_lanes.cu", _LIB_NAMES[design], _lanes_hashed(key),
                what=f"config {key}", flags=tuple(f"-D{d}" for d in lanes_defines(key)),
            )
        body = emit_body(*key)
        return build_library("fused_inverse.cu", _LIB_NAMES[design], _hashed(key, body),
                             files={"fused_body.inc": body}, what=f"config {key}")


def build(configs, design=None):
    """Build (in parallel, one nvcc each) the kernels of ``configs``, each
    a tuple ``(n, qfloat_len, qfloat_ints, qfloat_base, true_division)``
    with an optional trailing ``track``, in ``design`` (by default the one
    that serves each n), and load them."""
    jobs = [(k, _design(k, design)) for k in map(_key, configs)]
    run_parallel([functools.partial(_build_one, k, d) for k, d in jobs])
    for k, d in jobs:
        _library(k, d)


@functools.lru_cache(maxsize=None)
def _library(key, design="straight_line"):
    """The launch function of one built library, which takes the ``(B,
    n*n)`` arrays' four pointers (five tracked: the flags), the batch and
    the stream; and for the lanes design ``(threads, matrices)`` of a block,
    as the library gives them, else None."""
    with profiling.library(_LIB_NAMES[design]):
        lib = ctypes.CDLL(str(_build_one(key, design)))
    stem = ("fused_inverse_lanes" if design == "lanes" else "fused_inverse") \
        + ("_tracked" if key[5] else "")
    fn = getattr(lib, f"{stem}_launch")
    fn.argtypes = [ctypes.c_void_p] * (5 if key[5] else 4) + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if design != "lanes":
        return fn, None
    return fn, (lib.fused_inverse_lanes_block_threads(), lib.fused_inverse_lanes_mats_per_block())


def _library_int(config, design, name):
    key = _key(config)
    fn = getattr(ctypes.CDLL(str(_build_one(key, _design(key, design)))), name)
    fn.restype = ctypes.c_int
    return fn()


def block_threads(config, design=None):
    """The threads of a block of one config's kernel, read from its
    library (straight-line: the most of 128, 64 and 32 whose staging buffer
    fits 48 KB, ``csrc/fused_inverse.cu``; lanes: 128, or one group past
    n = 32); builds first if needed."""
    key = _key(config)
    design = _design(key, design)
    stem = "fused_inverse_lanes" if design == "lanes" else "fused_inverse"
    return _library_int(config, design, f"{stem}_block_threads")


def mats_per_block(config):
    """The matrices a block of one config's lanes kernel holds, read from
    its library: 4 floor(32/n) up to n = 32, then 1; builds first if
    needed."""
    return _library_int(config, "lanes", "fused_inverse_lanes_mats_per_block")


def lanes_smem_bytes(config):
    """The dynamic shared memory a block of one config's lanes kernel
    takes; builds first if needed."""
    return _library_int(config, "lanes", "fused_inverse_lanes_smem_bytes")


def _launch(fn, per_block, m, s, n, batch, track, design):
    """Allocate the outputs like ``m``, launch ``fn`` on the current stream
    and count the launch (``launch.fused_inverse[_lanes][_tracked]``), at
    n = 2 (the closed form) its matrices, and for the lanes design
    (``per_block``: a block's threads and matrices) its matrices' lanes and
    the lanes it launched; raises if the launch is refused."""
    om = torch.empty_like(m)
    os_ = torch.empty_like(s)
    ptrs = [m.data_ptr(), s.data_ptr(), om.data_ptr(), os_.data_ptr()]
    if track:
        flag = torch.empty(batch, dtype=torch.int32, device=m.device)
        ptrs.append(flag.data_ptr())
    with torch.cuda.device(m.device):
        err = fn(*ptrs, batch, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_inverse ({design}) kernel launch failed: cudaError {err}")
    profiling.count(_COUNTERS[design, bool(track)])
    if n == 2:
        profiling.count("k1.closed_form_matrices", batch)
    if per_block is not None:
        threads, mats = per_block
        profiling.count("lanes.matrix_lanes", batch * n)
        profiling.count("lanes.launched_lanes", -(-batch // mats) * threads)
    return (om, os_, flag) if track else (om, os_)


def fused_matrix_inverse(mags, signs, n, qfloat_len, qfloat_ints, qfloat_base,
                         true_division, track=False, design=None):
    """Whole batched inversion: ``(..., n*n)`` int64 magnitudes and signs in,
    the same out (contract of ``matrix_inversion_tpu/ops/fused_inverse.py``
    ``fused_matrix_inverse``), any n >= 2.  ``track=True`` returns ``(mags,
    signs, flag)`` with ``flag`` int32 of the batch shape.

    A CUDA tensor launches the kernel of ``design`` (by default the one
    that serves n, :func:`design_of`, tracked or not), once, on the tensors as they lie:
    the kernel takes the ``(B, n*n)`` layout, any batch size, and storage
    that is 8- but not 16-byte aligned (through 64-bit accesses).  Only an
    input that is not contiguous is copied first (``.contiguous()``).  A CPU
    tensor runs the plain version, whatever ``design`` says.
    """
    if n < 2:
        raise ValueError(f"the fused kernel takes n >= 2, got {n}")
    if mags.device.type == "cpu" and signs.device.type == "cpu":
        return fused_matrix_inverse_reference(
            mags, signs, n, qfloat_len, qfloat_ints, qfloat_base, true_division,
            track=track,
        )
    n2 = n * n
    if mags.device.type != "cuda" or signs.device != mags.device:
        raise ValueError(f"mags and signs must both be on one CUDA device, got {mags.device} "
                         f"and {signs.device}")
    if mags.dtype != torch.int64 or signs.dtype != torch.int64:
        raise TypeError("mags and signs must be int64")
    if mags.shape != signs.shape or mags.shape[-1:] != (n2,):
        raise ValueError(f"mags and signs must both have shape (..., {n2})")
    bshape = mags.shape[:-1]
    key = _key((n, qfloat_len, qfloat_ints, qfloat_base, true_division, track))
    design = _design(key, design)
    with profiling.span("k1"):
        out = _launch(*_library(key, design), mags.contiguous(), signs.contiguous(), n,
                      bshape.numel(), track, design)
    if track:
        return out[0], out[1], out[2].reshape(bshape)
    return out


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
