"""User-facing batched API.

Port of ``matrix_inversion_tpu/runtime/api.py:287-441``, packed I/O only:
``BatchedMatrixInversion`` inverts (B, n, n) float batches in one device
program.  PyTorch runs eagerly, so there is no compile step.  The device
defaults to the card: the CPU runs only for a caller who names it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import QFloatParams
from ..models.inverse import qfloat_matrix_inverse_packed_io, qfloat_matrix_inverse_with_overflow
from ..models.marshal import float_matrix_to_mags_and_signs, mags_and_signs_to_float_matrix


class BatchedMatrixInversion:
    """Invert (B, n, n) float matrices in QFloat arithmetic on ``device``
    (default ``"cuda"``; without a CUDA device the constructor raises, and
    the CPU is used only when asked for by name).

    The stages are ``quantize`` (host float64 -> int64 magnitudes and signs
    on the device), ``run_raw`` (device tensors in, device tensors out,
    asynchronous on CUDA) and ``dequantize`` (device -> host float64);
    ``run`` chains the three.  On a CUDA device ``lowering="auto"`` runs
    the fused kernel (ops/fused_inverse.py) for n <= 12 and the op-by-op
    path beyond, whose divisions go through the K2/K3 kernels and whose
    untracked base-2 multiplies go through K4 (ops/long_division.py); "unroll", "vec" and "scan" run the op-by-op
    path at any n.

    ``track_overflow=True`` runs the tracked circuit
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
        io: str = "packed",
        in_shardings=None,
        out_shardings=None,
        donate: bool = False,
        data_parallel: bool = None,
        track_overflow: bool = False,
        *,
        device="cuda",
    ):
        """The arguments up to ``track_overflow`` are the reference's, in
        its order (``matrix_inversion_tpu/runtime/api.py:297-308``), so a
        positional call means the same in both.  ``io`` defaults to
        ``"packed"``, the one form ported (the reference's default is
        ``"digits"``).  ``donate`` is accepted and does nothing: eager
        PyTorch has no buffers to donate.  ``data_parallel=None`` (auto)
        and ``False`` both mean one device; ``True`` and the shardings
        raise until multi-device batching is ported."""
        if io not in ("digits", "packed"):
            raise ValueError("io must be digits|packed")
        if track_overflow and io != "packed":
            raise ValueError("track_overflow requires io='packed'")
        if io == "digits":
            raise NotImplementedError(
                "io='digits' is not ported yet (ROADMAP queue 1, item 7)"
            )
        if data_parallel or in_shardings is not None or out_shardings is not None:
            raise NotImplementedError(
                "multi-device batching is not ported yet (ROADMAP queue 1, item 10)"
            )
        if backend != "auto":
            params = params.replace(backend=backend)
        params.resolve_backend()
        self.params = params
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedMatrixInversion targets a CUDA device and none is available; "
                'pass device="cpu" to run the plain PyTorch path'
            )
        self.track_overflow = bool(track_overflow)

    def quantize(self, matrices: np.ndarray):
        """(B, n, n) float64 -> ((B, n*n) int64 magnitudes, signs) on the device."""
        p = self.params
        mags, signs = float_matrix_to_mags_and_signs(
            matrices, p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )
        return (
            torch.from_numpy(mags).to(self.device),
            torch.from_numpy(signs).to(self.device),
        )

    def dequantize(self, out):
        """(magnitudes, signs) device tensors -> (B, n, n) float64 on the
        host; with tracking, (magnitudes, signs, flags) -> (inverses,
        int32 flags)."""
        p = self.params
        matrices = mags_and_signs_to_float_matrix(
            out[0].cpu().numpy(), out[1].cpu().numpy(),
            p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        )
        if self.track_overflow:
            return matrices, out[2].cpu().numpy()
        return matrices

    def run_raw(self, mags, signs):
        """Device input tensors -> device output tensors."""
        p = self.params
        shape = (self.batch_size, p.n * p.n)
        if mags.shape != shape or signs.shape != shape:
            raise ValueError(f"expected mags and signs of shape {shape}")
        for t in (mags, signs):
            if t.device.type != self.device.type or self.device.index not in (
                None, t.device.index
            ):
                raise ValueError(f"expected tensors on {self.device}, got {t.device}")
        fn = (qfloat_matrix_inverse_with_overflow if self.track_overflow
              else qfloat_matrix_inverse_packed_io)
        return fn(
            mags, signs, p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            p.true_division, lowering=p.lowering,
        )

    def run(self, matrices: np.ndarray):
        """Invert a (B, n, n) float batch; returns the (B, n, n) inverses,
        or ``(inverses, flags)`` with tracking."""
        p = self.params
        if matrices.shape != (self.batch_size, p.n, p.n):
            raise ValueError(
                f"expected matrices of shape {(self.batch_size, p.n, p.n)}"
            )
        return self.dequantize(self.run_raw(*self.quantize(matrices)))
