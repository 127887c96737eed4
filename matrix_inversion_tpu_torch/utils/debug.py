"""Debug tools: PLU comparison dumps and single-shot QFloat inversion.

Port of ``matrix_inversion_tpu/utils/debug.py:28-124`` (the reference debug
harness, qfloat_matrix_inversion.py:763-880): run the QFloat circuit on one
matrix and compare P/L/U/Y/X against the float oracle.  The same signatures,
plus ``device`` (the card by default; the CPU only when named).  On the card
``run_qfloat_inverse`` takes the circuit's own route (K1 for n <= 12), and
the decompositions run op by op through the division and multiply kernels.
Only the packed backend is ported: another ``backend`` raises naming ROADMAP
queue 1, item 7b.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import QFloatParams
from ..core.qfloat import QFloatBase, SignedBinary, Zero
from ..models import lu_float
from ..models.inverse import qfloat_matrix_inverse
from ..models.marshal import (
    float_matrix_to_qfloat_arrays,
    qfloat_and_signs_arrays_to_float_matrix,
    qfloat_arrays_to_qfloat_matrix,
    qfloat_matrix_to_arrays_and_signs,
)
from ..models.qfloat_lu import map_2D_list, qfloat_lu_decomposition, qfloat_lu_inverse
from ..runtime.api import _target


def _host(value):
    """A cell value (Python int or tensor) as numpy on the host."""
    return value.cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _to_float(cell):
    """One matrix's cell as a Python float, whatever its type."""
    if isinstance(cell, QFloatBase):
        return float(cell.to_float())
    if isinstance(cell, Zero):
        return 0.0
    if isinstance(cell, SignedBinary):
        return float(_host(cell.value))
    return float(_host(cell))


def _digits_on(M, p, device, who):
    """One matrix quantized on the host, as digit and sign tensors on the
    device."""
    digits, signs = float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    device = _target(device, who)
    return torch.from_numpy(digits).to(device), torch.from_numpy(signs).to(device)


def _decomposition(M, p, backend, device, who):
    """(P^T, L, U) cell matrices of one matrix's QFloat PLU, and its sign
    tensor."""
    digits, signs = _digits_on(M, p, device, who)
    qfloat_M = qfloat_arrays_to_qfloat_matrix(digits, signs, p.qfloat_ints, p.qfloat_base,
                                              backend)
    return qfloat_lu_decomposition(qfloat_M, p.qfloat_len, p.qfloat_ints, p.true_division), signs


def run_qfloat_inverse(M, params: QFloatParams, backend=None, *, device="cuda"):
    """One QFloat inversion -> float matrix (reference :831-845)."""
    p = params
    backend = backend or p.resolve_backend()
    digits, signs = _digits_on(M, p, device, "run_qfloat_inverse")
    out = qfloat_matrix_inverse(
        digits, signs, p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
        p.true_division, False, backend,
    )
    return qfloat_and_signs_arrays_to_float_matrix(out.cpu().numpy(), p.qfloat_ints,
                                                   p.qfloat_base)


def compare_plu(M, params: QFloatParams, backend=None, verbose=True, *, device="cuda"):
    """QFloat PLU vs float-oracle PLU (reference test_qfloat_PLU_python,
    :763-828).  Returns dict of (P, L, U) pairs and max abs deviations."""
    p = params
    backend = backend or p.resolve_backend()
    (bin_P, qf_L, qf_U), signs = _decomposition(M, p, backend, device, "compare_plu")
    P = np.array(map_2D_list(bin_P, lambda x: _host(x.value)))

    def to_float_matrix(cells):
        arrays = qfloat_matrix_to_arrays_and_signs(
            cells, p.qfloat_len, p.qfloat_ints, p.qfloat_base,
            batch_shape=signs.shape[:-1], device=signs.device,
        )
        return qfloat_and_signs_arrays_to_float_matrix(arrays.cpu().numpy(), p.qfloat_ints,
                                                       p.qfloat_base)

    L, U = to_float_matrix(qf_L), to_float_matrix(qf_U)
    P_, L_, U_ = lu_float.lu_decomposition(np.asarray(M, dtype=np.float64))
    result = {
        "P": (P, P_),
        "L": (L, L_),
        "U": (U, U_),
        "max_dev": {
            "P": float(np.max(np.abs(P - P_))),
            "L": float(np.max(np.abs(L - L_))),
            "U": float(np.max(np.abs(U - U_))),
        },
    }
    if verbose:
        for name in ("P", "L", "U"):
            qf, fl = result[name]
            print(f" {name} MATRIX\n============")
            print(f"QFloat {name} :\n{qf}\n")
            print(f"PLU {name} :\n{fl}\n")
    return result


def debug_inverse(M, params: QFloatParams, backend=None, verbose=True, *, device="cuda"):
    """Full L/U/Y/X dump vs the float oracle for a suspect matrix
    (reference debug path, :921-967)."""
    p = params
    backend = backend or p.resolve_backend()
    (bin_P, qf_L, qf_U), _ = _decomposition(M, p, backend, device, "debug_inverse")
    Minv, qf_Y, qf_X = qfloat_lu_inverse(
        bin_P, qf_L, qf_U, p.qfloat_len, p.qfloat_ints, p.true_division, debug=True,
    )
    L = map_2D_list(qf_L, _to_float)
    U = map_2D_list(qf_U, _to_float)
    Y = map_2D_list(qf_Y, _to_float)
    X = map_2D_list(qf_X, _to_float)
    P_, L_, U_ = lu_float.lu_decomposition(np.asarray(M, dtype=np.float64))
    Minv_, Y_, X_ = lu_float.lu_inverse(P_, L_, U_, debug=True)
    if verbose:
        print("\nL", L, L_, "\nU", U, U_, "\nX", X, X_, "\nY", Y, Y_, sep="\n")
    return {"L": (L, L_), "U": (U, U_), "Y": (Y, Y_), "X": (X, X_)}
