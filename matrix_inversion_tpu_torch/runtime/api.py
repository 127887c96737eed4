"""User-facing API: one matrix through the reference's lifecycle, and batches.

Port of ``matrix_inversion_tpu/runtime/api.py:143-441``.
``EncryptedMatrixInversion`` keeps the reference's lifecycle
(reference main.py:17-116) for one matrix; ``BatchedMatrixInversion``
inverts (B, n, n) float batches on one device or, data-parallel, once per
card of a mesh (``parallel/mesh.py``).  Both take digit
I/O (``io="digits"``, the reference's default: ``(..., n*n, len)`` digits
in, ``(..., n*n, len+1)`` out) or packed I/O (``io="packed"``: one int64
magnitude and one sign a cell; the packed backend only).  The backend is
``params.resolve_backend()``: packed where the encoding fits in int64, else
the limb backend (digit arrays, any base), on digit I/O only.  PyTorch runs
eagerly, so there is no compile step.  The device defaults to the card: the CPU runs only for a
caller who names it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..config import QFloatParams
from ..models.inverse import (
    check_lowering,
    qfloat_matrix_inverse,
    qfloat_matrix_inverse_packed_io,
    qfloat_matrix_inverse_with_overflow,
)
from ..models.marshal import (
    float_matrix_to_mags_and_signs,
    float_matrix_to_qfloat_arrays,
    mags_and_signs_to_float_matrix,
    qfloat_and_signs_arrays_to_float_matrix,
)
from ..parallel.mesh import Mesh, ShardedProgram, data_parallel_inverse_fused, make_mesh


def _check_io(io, track_overflow, backend, packed_io_message):
    """The reference's ``ValueError``s for ``io`` and ``track_overflow``
    on ``backend``, in its order."""
    if io not in ("digits", "packed"):
        raise ValueError("io must be digits|packed")
    if io == "packed" and backend != "packed":
        raise ValueError(packed_io_message)
    if track_overflow and io != "packed":
        raise ValueError("track_overflow requires io='packed'")


def _target(device, who):
    """``torch.device(device)``; raises for a CUDA device when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} targets a CUDA device and none is available; "
            'pass device="cpu" to run the plain PyTorch path'
        )
    return device


def _first(shardings):
    """The first sharding of ``shardings`` (one, or a tuple of them)."""
    return shardings[0] if isinstance(shardings, (tuple, list)) else shardings


def _sharded_axes(spec):
    """``(batch, cells)``: whether ``spec`` shards the batch axis over
    ``data`` and the cell axis over ``cell``; raises for any other
    sharding."""
    parts = tuple(spec) + (None, None)
    if parts[0] not in (None, "data") or parts[1] not in (None, "cell") or any(parts[2:]):
        raise ValueError(f"the port shards the batch axis over 'data' and the cell axis over "
                         f"'cell', not {spec!r}")
    return parts[0] == "data", parts[1] == "cell"


def _circuit(params: QFloatParams, backend: str, io: str, track: bool, lowering=None):
    """The circuit body of one configuration: device tensors in, device
    tensors out; ``lowering`` overrides the params' own.  A lowering that
    ``backend`` does not have raises here."""
    p = params
    args = dict(n=p.n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
                qfloat_base=p.qfloat_base, true_division=p.true_division,
                lowering=lowering or p.lowering)
    if io == "digits":
        check_lowering(backend, args["lowering"])
        return functools.partial(qfloat_matrix_inverse, tensorize=p.tensorize, backend=backend,
                                 **args)
    fn = qfloat_matrix_inverse_with_overflow if track else qfloat_matrix_inverse_packed_io
    return functools.partial(fn, **args)


def _quantize(params: QFloatParams, io: str, matrices, out=None):
    """Host float64 (..., n, n) -> the circuit's numpy inputs: digits
    ``(..., n*n, len)`` and signs for digit I/O, magnitudes and signs
    ``(..., n*n)`` for packed I/O, all int64; written into ``out`` when it
    is given."""
    p = params
    fn = float_matrix_to_qfloat_arrays if io == "digits" else float_matrix_to_mags_and_signs
    return fn(matrices, p.qfloat_len, p.qfloat_ints, p.qfloat_base, out=out)


def _dequantize(params: QFloatParams, io: str, out):
    """Host numpy circuit outputs -> float64 (..., n, n)."""
    p = params
    if io == "digits":
        return qfloat_and_signs_arrays_to_float_matrix(out, p.qfloat_ints, p.qfloat_base)
    return mags_and_signs_to_float_matrix(out[0], out[1], p.qfloat_len, p.qfloat_ints,
                                          p.qfloat_base)


class EncryptedMatrixInversion:
    """Single-matrix inversion with the reference's lifecycle (reference
    main.py:17-116), on ``device`` (default ``"cuda"``; without a CUDA
    device the constructor raises, and the CPU is used only when asked for
    by name).

    ``keygen`` is a no-op, ``quantize`` gives host numpy arrays,
    ``encrypt`` puts them on the device as int64 tensors, ``evaluate`` runs
    the circuit there (on CUDA, packed: K1 for n <= 12 and the op-by-op path
    beyond; limb: op by op with K6 and K7), ``decrypt`` brings the result
    back as numpy (a tuple for packed io) and ``dequantize`` gives the
    float64 (n, n) inverse; ``run`` chains them.  ``run(M, simulate=True)``
    runs the same circuit op by op (``lowering="unroll"``) on the same
    device: the port's counterpart of the reference's uncompiled eager body,
    which on the card holds K1 against the op-by-op kernels K2 and K4 (on
    the limb backend it is the same path as ``run``).
    """

    def __init__(
        self,
        n,
        sampler: Optional[Callable] = None,
        qfloat_base=2,
        qfloat_len=32,
        qfloat_ints=16,
        true_division=False,
        tensorize=False,
        backend="auto",
        io="digits",
        track_overflow=False,
        *,
        device="cuda",
    ):
        """The arguments up to ``track_overflow`` are the reference's, in its
        order (``matrix_inversion_tpu/runtime/api.py:146-158``).
        ``tensorize`` groups the limb backend's multiplies and reciprocals
        (the same results).  ``track_overflow=True`` (packed io only):
        ``run`` returns ``(inverse, overflowed)`` with a scalar int overflow
        flag."""
        self.shape = (n, n)
        self.params = QFloatParams(
            n=n,
            qfloat_len=qfloat_len,
            qfloat_ints=qfloat_ints,
            qfloat_base=qfloat_base,
            true_division=true_division,
            tensorize=tensorize,
            backend=backend,
        )
        self.backend = self.params.resolve_backend()
        _check_io(io, track_overflow, self.backend,
                  "packed io requires the packed backend (base=2^k encoding that fits in int64)")
        self.io = io
        self.track_overflow = bool(track_overflow)
        if sampler is not None:
            # the reference's input-set validation (reference main.py:41-46)
            for _ in range(3):
                sample = sampler()
                assert isinstance(sample, np.ndarray)
                assert np.issubdtype(sample.dtype, np.floating)
                assert sample.shape == self.shape
        self.device = _target(device, "EncryptedMatrixInversion")
        self.circuit = _circuit(self.params, self.backend, io, self.track_overflow)
        self._simulate = _circuit(self.params, self.backend, io, self.track_overflow,
                                  lowering="unroll")

    # ---- lifecycle steps (reference main.py:68-91) ------------------------
    def keygen(self):
        """FHE key generation has no counterpart; kept for API parity."""
        return None

    def quantize(self, matrix: np.ndarray):
        """(n, n) float64 -> host numpy (digits (n*n, len) or magnitudes
        (n*n,), and signs (n*n,))."""
        return _quantize(self.params, self.io, matrix)

    def encrypt(self, quantized_matrix, qfloat_signs):
        """Commit the quantized matrix to the device as int64 tensors."""
        return (
            torch.as_tensor(quantized_matrix, dtype=torch.int64).to(self.device),
            torch.as_tensor(qfloat_signs, dtype=torch.int64).to(self.device),
        )

    def evaluate(self, encrypted):
        return self.circuit(*encrypted)

    def decrypt(self, encrypted_result):
        """Device result -> numpy on the host (a tuple for packed io)."""
        if isinstance(encrypted_result, tuple):
            return tuple(o.cpu().numpy() for o in encrypted_result)
        return encrypted_result.cpu().numpy()

    def dequantize(self, quantized_inverted_matrix):
        """Host numpy result -> (n, n) float64, and with tracking the int flag."""
        matrix = _dequantize(self.params, self.io, quantized_inverted_matrix)
        if self.track_overflow:
            return matrix, int(quantized_inverted_matrix[2])
        return matrix

    def run(self, matrix: np.ndarray, simulate=False):
        """Invert one matrix.  Returns the (n, n) inverse, or
        ``(inverse, overflowed)`` when ``track_overflow`` is set."""
        assert np.issubdtype(matrix.dtype, np.floating)
        assert matrix.shape == self.shape
        encrypted = self.encrypt(*self.quantize(matrix))
        circuit = self._simulate if simulate else self.circuit
        out = self.dequantize(self.decrypt(circuit(*encrypted)))
        inverted = out[0] if self.track_overflow else out
        assert np.issubdtype(inverted.dtype, np.floating)
        assert inverted.shape == self.shape
        return out


class BatchedMatrixInversion:
    """Invert (B, n, n) float matrices in QFloat arithmetic on ``device``
    (default ``"cuda"``; without a CUDA device the constructor raises, and
    the CPU is used only when asked for by name).

    The stages are ``quantize`` (host float64 -> int64 tensors on the
    device: digits ``(B, n*n, len)`` and signs ``(B, n*n)`` for
    ``io="digits"``, magnitudes and signs ``(B, n*n)`` for ``io="packed"``),
    ``run_raw`` (device tensors in, device tensors out, asynchronous on
    CUDA) and ``dequantize`` (device -> host float64); ``run`` chains the
    three.  ``runtime/stream.py::StreamingInverter`` pipelines the same
    stages over a stream of batches.  On the packed backend and a CUDA
    device ``lowering="auto"`` runs the fused kernel (ops/fused_inverse.py)
    for n <= 12 and the op-by-op path beyond, whose divisions go through
    the K2/K3 kernels and whose untracked base-2 multiplies go through K4
    (ops/long_division.py); "unroll", "vec" and "scan" run the op-by-op
    path at any n.  Digit I/O packs and unpacks around the same circuit on
    the device.  On the limb backend (digit I/O only) the circuit runs op by
    op on digit arrays, its long divisions in K6 and its carry chains in K7
    (ops/limb_kernels.py).

    ``track_overflow=True`` (packed io only) runs the tracked circuit
    (``qfloat_matrix_inverse_with_overflow``, on CUDA the tracked kernel):
    ``run_raw`` then returns ``(mags, signs, flags)`` and ``dequantize`` and
    ``run`` return ``(inverses, flags)``, ``flags`` a numpy int32 ``(B,)``
    that is 1 where a matrix overflowed its QFloat range.
    """

    def __init__(
        self,
        params: QFloatParams,
        batch_size: int,
        backend: str = "auto",
        io: str = "digits",
        in_shardings=None,
        out_shardings=None,
        donate: bool = False,
        data_parallel: bool = None,
        track_overflow: bool = False,
        *,
        device="cuda",
    ):
        """The arguments up to ``track_overflow`` are the reference's, in
        its order and with its defaults
        (``matrix_inversion_tpu/runtime/api.py:297-308``), so a positional
        call means the same in both.  ``donate`` is accepted and does
        nothing: eager PyTorch has no buffers to donate.

        ``data_parallel=True`` runs K1 once per card of ``make_mesh()``
        (``parallel/mesh.py::data_parallel_inverse_fused``; on
        ``device="cpu"`` over the 8-entry CPU mesh, each shard on K1's plain
        version; on a card the caller named by index, ``"cuda:1"``, over
        that card alone); it needs ``io="packed"`` and a batch divisible by
        the mesh's size.  ``None`` and ``False`` are one device, unlike the
        JAX package's auto choice: ``run_raw`` takes and returns whole
        tensors on the first card, and carrying the other cards' shards
        through it makes the mesh slower than one card (``PERF.md`` §5).
        ``in_shardings``/``out_shardings`` take
        :class:`~..parallel.mesh.NamedSharding`s (one, or one per input or
        output; the first input's, else the first output's, decides): a spec
        whose first entry is ``"data"`` runs the circuit once per data
        shard, a second entry ``"cell"`` gathers the cells first, and
        ``P()`` runs on one device.  Whatever the sharding, the values equal
        the one-device run's, and ``run_raw`` takes and returns whole tensors
        on the first device of the mesh (``self.device``), which ``mesh``
        names (None for one device)."""
        if backend != "auto":
            params = params.replace(backend=backend)
        self.backend = params.resolve_backend()
        _check_io(io, track_overflow, self.backend, "packed io requires the packed backend")
        self.params = params
        self.io = io
        self.batch_size = int(batch_size)
        self.device = _target(device, "BatchedMatrixInversion")
        self.track_overflow = bool(track_overflow)
        self.mesh = None
        if data_parallel:
            if io != "packed":
                raise ValueError("data_parallel requires io='packed'")
            mesh = (make_mesh(device=self.device) if self.device.index is None
                    else Mesh([self.device], ("data",)))
            if batch_size % mesh.size:
                raise ValueError(
                    f"data_parallel needs batch_size divisible by device_count ({mesh.size})"
                )
            self._use(mesh, data_parallel_inverse_fused(params, mesh, track=self.track_overflow))
            return
        self._circuit = _circuit(params, self.backend, io, self.track_overflow)
        if in_shardings is not None or out_shardings is not None:
            sharding = _first(in_shardings) or _first(out_shardings)
            batch, cells = _sharded_axes(sharding.spec)
            mesh = sharding.mesh
            if mesh.devices.flat[0].type != self.device.type:
                raise ValueError(f"the sharding's mesh lies on {mesh.devices.flat[0]}, the "
                                 f"inverter on {self.device}")
            self._use(mesh, ShardedProgram(self._circuit, mesh, batch, cells)
                      if batch or cells else self._circuit)

    def _use(self, mesh, circuit):
        """Run ``circuit`` over ``mesh``, whose first device takes the
        inputs and holds the outputs."""
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        self._circuit = circuit

    def input_shapes(self):
        """The shapes of ``run_raw``'s two int64 inputs: digits
        ``(B, n*n, len)`` or magnitudes ``(B, n*n)``, and signs ``(B, n*n)``."""
        p = self.params
        shape = (self.batch_size, p.n * p.n)
        return shape + ((p.qfloat_len,) if self.io == "digits" else ()), shape

    def _host_quantize(self, matrices, out=None):
        """The host half of ``quantize``: (B, n, n) float64 -> the circuit's
        int64 inputs as numpy arrays, written into ``out`` when it is given."""
        return _quantize(self.params, self.io, matrices, out=out)

    def _host_dequantize(self, host):
        """The host half of ``dequantize``: the circuit's outputs as numpy
        arrays -> (B, n, n) float64, and with tracking a copy of the flags."""
        if self.io == "digits":
            return _dequantize(self.params, self.io, host)
        matrices = _dequantize(self.params, self.io, host[:2])
        if self.track_overflow:
            return matrices, np.array(host[2])
        return matrices

    def quantize(self, matrices: np.ndarray):
        """(B, n, n) float64 -> the circuit's two int64 input tensors on the device."""
        return tuple(torch.from_numpy(a).to(self.device) for a in self._host_quantize(matrices))

    def dequantize(self, out):
        """Device output -> (B, n, n) float64 on the host; with tracking,
        (magnitudes, signs, flags) -> (inverses, int32 flags)."""
        if self.io == "digits":
            return self._host_dequantize(out.cpu().numpy())
        return self._host_dequantize([o.cpu().numpy() for o in out])

    def run_raw(self, a, signs):
        """Device input tensors (digits or magnitudes, and signs) -> device
        output tensors."""
        a_shape, shape = self.input_shapes()
        if a.shape != a_shape or signs.shape != shape:
            raise ValueError(f"expected inputs of shapes {a_shape} and {shape}")
        for t in (a, signs):
            if t.device.type != self.device.type or self.device.index not in (
                None, t.device.index
            ):
                raise ValueError(f"expected tensors on {self.device}, got {t.device}")
        return self._circuit(a, signs)

    def run(self, matrices: np.ndarray):
        """Invert a (B, n, n) float batch; returns the (B, n, n) inverses,
        or ``(inverses, flags)`` with tracking."""
        p = self.params
        if matrices.shape != (self.batch_size, p.n, p.n):
            raise ValueError(
                f"expected matrices of shape {(self.batch_size, p.n, p.n)}"
            )
        return self.dequantize(self.run_raw(*self.quantize(matrices)))
