"""QFloat encoding and algorithm configuration for the PyTorch/CUDA port.

Same fields, presets, validation and backend choice as
``matrix_inversion_tpu/config.py`` minus what the port does not carry: the
module-global performance knobs and their cache keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

LOWERINGS = ("auto", "unroll", "vec", "scan", "fused")


@dataclasses.dataclass(frozen=True)
class QFloatParams:
    """Static QFloat encoding + algorithm configuration.

    Attributes:
      n:             matrix dimension (n x n).
      qfloat_len:    total number of base-p digits per QFloat.
      qfloat_ints:   number of digits before the dot.
      qfloat_base:   digit base p (2 = binary).
      true_division: true long divisions in LU instead of multiplying by a
                     precomputed reciprocal.
      tensorize:     group independent QFloat multiplies and reciprocals
                     into one wide op (reference qfloat.py:1023-1181); it
                     changes only the limb backend's grouping, never a
                     result.
      backend:       "packed" (int64 magnitudes, power-of-two bases),
                     "limb" (digit arrays, any base) or "auto" (packed
                     whenever the encoding fits in int64, else limb).
      lowering:      "fused" runs the whole inversion as one CUDA kernel
                     (ops/fused_inverse.py, any n); "unroll", "vec" and
                     "scan" run the op-by-op path (the circuit as eager
                     PyTorch ops, divisions and base-2 multiplies on the
                     card through the K2/K3/K4 kernels; JAX's "vec" and
                     "scan" only cap its compile time); "auto" picks
                     fused for CUDA tensors with n <= 12 and the op-by-op
                     path otherwise.  Results are bit-identical.
    """

    n: int = 2
    qfloat_len: int = 23
    qfloat_ints: int = 9
    qfloat_base: int = 2
    true_division: bool = False
    tensorize: bool = False
    backend: str = "auto"
    lowering: str = "auto"

    def __post_init__(self):
        if self.qfloat_base < 2:
            raise ValueError("qfloat_base must be >= 2")
        if not (0 <= self.qfloat_ints <= self.qfloat_len):
            raise ValueError("qfloat_ints must be in [0, qfloat_len]")
        if self.backend not in ("auto", "packed", "limb"):
            raise ValueError("backend must be auto|packed|limb")
        if self.lowering not in LOWERINGS:
            raise ValueError("lowering must be auto|unroll|vec|scan|fused")

    @property
    def frac(self) -> int:
        """Number of digits after the dot."""
        return self.qfloat_len - self.qfloat_ints

    def digit_bits(self) -> Optional[int]:
        """log2(base) if base is a power of two, else None."""
        b = self.qfloat_base
        if b & (b - 1) == 0:
            return b.bit_length() - 1
        return None

    def packed_ok(self) -> bool:
        """Whether int64 magnitudes can hold this encoding: the widest
        intermediate, the ``invert`` dividend of ``1 + frac + len`` digits,
        must stay under 2**62."""
        bits = self.digit_bits()
        if bits is None:
            return False
        return (1 + self.frac + self.qfloat_len) * bits <= 62

    def resolve_backend(self) -> str:
        """"packed" or "limb": ``auto`` takes packed whenever
        :meth:`packed_ok`, else limb; an explicit "packed" that does not fit
        raises."""
        if self.backend == "auto":
            return "packed" if self.packed_ok() else "limb"
        if self.backend == "packed" and not self.packed_ok():
            raise ValueError(
                f"packed backend cannot represent base={self.qfloat_base} "
                f"len={self.qfloat_len} (needs base**(~3*len) < 2**62)"
            )
        return self.backend

    def replace(self, **kw) -> "QFloatParams":
        return dataclasses.replace(self, **kw)

    def as_list(self):
        """Positional params list, for reference-shaped call sites
        (``matrix_inversion_tpu/config.py:106-115``)."""
        return [self.n, self.qfloat_len, self.qfloat_ints, self.qfloat_base,
                self.true_division, self.tensorize]


def from_jax_params(p) -> QFloatParams:
    """Copy a JAX ``QFloatParams`` (any object with the same attributes)
    into the port's."""
    return QFloatParams(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(QFloatParams)}
    )


# Precision presets (reference README.md:107-116, main.py:135-155).
LOW = QFloatParams(qfloat_len=23, qfloat_ints=9, true_division=False)
MEDIUM = QFloatParams(qfloat_len=31, qfloat_ints=16, true_division=False)
MEDIUM_PLUS = QFloatParams(qfloat_len=31, qfloat_ints=16, true_division=True)
HIGH = QFloatParams(qfloat_len=40, qfloat_ints=20, true_division=True)

PRESETS = {
    "low": LOW,
    "medium": MEDIUM,
    "medium+": MEDIUM_PLUS,
    "high": HIGH,
}
