"""matrix_inversion_tpu_torch -- the PyTorch/CUDA port of matrix_inversion_tpu.

Exact batched matrix inversion in QFloat fixed-point arithmetic, with the
same semantics, bit for bit, as the JAX package ``matrix_inversion_tpu``
(the reference, kept beside it).  Ported so far: on the packed backend
(int64 magnitudes, power-of-two bases) the inverse at any n with digit
I/O and packed I/O, untracked and with per-matrix overflow flags; on the
limb backend (``QFloat`` digit arrays, any base) the inverse with digit
I/O; the single-matrix lifecycle ``EncryptedMatrixInversion``, the
partial pivot/L/U circuits with the float oracle, streaming, the CLI and
the user's tools, and the roofline path with the issue-rate probes.  Not
yet: multi-device batching.

* ``config``        -- QFloatParams and the Low/Medium/Medium+/High presets;
* ``core.qfloat``   -- the Zero / SignedBinary / QFloatBase dispatch layer
  and QFloat, the limb backend's number type;
* ``ops.limbs`` + ``ops.limb_kernels`` + ``csrc/`` -- digit-array arithmetic
  of any base, its long division (K6) and carry chains (K7) as kernels for
  sm_90a;
* ``ops.radix``     -- host radix conversion (numpy);
* ``ops.packed``    -- PackedQFloat on int64 tensors (eager path, and the
  semantic spec of the kernels), the ``track_overflow`` scope, and the
  division routing switch ``set_division_impl``;
* ``ops.long_division`` + ``csrc/`` -- the division kernels K2/K3 and the
  windowed-multiply kernel K4 of the op-by-op path, for sm_90a;
* ``ops.emit``      -- emits the kernel body as C++ from the circuit;
* ``ops.fused_inverse`` + ``csrc/`` -- the fused whole-inversion CUDA
  kernel for sm_90a (untracked and tracked), its wrapper and its plain
  version;
* ``models``        -- pivoting/LU/substitution/2x2 circuit and the op-by-op
  path, digit and packed marshalling, the digit-I/O and packed-I/O entry
  points (untracked and with overflow), the partial circuits, and the
  float LU oracle ``models.lu_float``;
* ``runtime.api``   -- EncryptedMatrixInversion and BatchedMatrixInversion
  (on the card unless the caller names the CPU; digit I/O by default);
* ``utils.samplers``, ``utils.timing``, ``utils.profiling`` -- matrix
  samplers, chained timing on CUDA events, ``torch.profiler`` traces and
  the QFloat op counters;
* ``utils.ubench`` + ``csrc/ubench.cu`` -- the issue-rate probes K5: op-mix
  chains timed on the card, for sm_90a;
* ``utils.roofline`` -- op counts of the eager circuit, the histogram of
  K1's emitted body, and the measured-rate roofline.

The ``utils`` modules are imported by name
(``from matrix_inversion_tpu_torch.utils import roofline, ubench``), as in
the JAX package; ``python -m matrix_inversion_tpu_torch.utils.ubench`` and
``...utils.roofline`` run them.

The package imports torch and numpy, never jax.
"""

from .config import HIGH, LOW, MEDIUM, MEDIUM_PLUS, PRESETS, QFloatParams
from .core.qfloat import QFloat, QFloatBase, SignedBinary, Zero
from .models.inverse import (
    qfloat_lu_L,
    qfloat_lu_U,
    qfloat_matrix_inverse,
    qfloat_matrix_inverse_packed_io,
    qfloat_matrix_inverse_with_overflow,
    qfloat_pivot,
)
from .models.marshal import float_matrix_to_qfloat_arrays, qfloat_and_signs_arrays_to_float_matrix
from .ops.packed import PackedQFloat, set_division_impl, track_overflow
from . import utils
from .runtime.api import BatchedMatrixInversion, EncryptedMatrixInversion

__all__ = [
    "QFloatParams",
    "PRESETS",
    "LOW",
    "MEDIUM",
    "MEDIUM_PLUS",
    "HIGH",
    "QFloatBase",
    "QFloat",
    "SignedBinary",
    "Zero",
    "PackedQFloat",
    "track_overflow",
    "set_division_impl",
    "qfloat_matrix_inverse",
    "qfloat_pivot",
    "qfloat_lu_L",
    "qfloat_lu_U",
    "float_matrix_to_qfloat_arrays",
    "qfloat_and_signs_arrays_to_float_matrix",
    "qfloat_matrix_inverse_packed_io",
    "qfloat_matrix_inverse_with_overflow",
    "EncryptedMatrixInversion",
    "BatchedMatrixInversion",
    "utils",
]
