"""Zero / SignedBinary / QFloatBase: the static number-type layer.

Port of ``matrix_inversion_tpu/core/qfloat.py:61-325,793-822`` with the
same meaning, the op counters (``:189-210``) included.  ``Zero`` and ``SignedBinary`` are Python-level types whose
dispatch prunes work while the circuit is built: the static pruning is
what fixes the op sequence, so the eager PyTorch circuit and the CUDA
kernel body emitted from it (ops/emit.py) run the same ops as the
reference.  Values inside ``SignedBinary`` and QFloat signs are Python
ints, int64 tensors, or (while emitting) integer symbols; every operator
used here works on all three.
"""

from __future__ import annotations

import numbers


class Zero:
    """Build-time-known zero; absorbs ops without emitting device work."""

    def copy(self):
        return self

    def __add__(self, other):
        return self if isinstance(other, Zero) else other

    def __radd__(self, other):
        return self if isinstance(other, Zero) else other

    def __sub__(self, other):
        return self if isinstance(other, Zero) else -other

    def __rsub__(self, other):
        return other

    def __mul__(self, other):
        return self

    def __rmul__(self, other):
        return self

    def __truediv__(self, other):
        if isinstance(other, Zero):
            raise ValueError("division by Zero")
        return self

    def __rtruediv__(self, other):
        raise ValueError("division by Zero")

    def __neg__(self):
        return self

    def neg(self):
        return self

    def __abs__(self):
        return self


class SignedBinary:
    """A value known to be in {-1, 0, +1} (scalar or batched)."""

    def __init__(self, value):
        self._value = value

    @property
    def value(self):
        return self._value

    def copy(self):
        return SignedBinary(self._value)

    def __add__(self, other):
        if isinstance(other, SignedBinary):
            return self._value + other._value  # potentially no longer binary
        if isinstance(other, QFloatBase):
            return other.__add__(self)
        return self._value + other

    def __sub__(self, other):
        if isinstance(other, SignedBinary):
            return self._value - other._value
        if isinstance(other, QFloatBase):
            return other.__rsub__(self)
        return self._value - other

    def __mul__(self, other):
        if isinstance(other, SignedBinary):
            return SignedBinary(self._value * other._value)
        if isinstance(other, QFloatBase):
            return other.__mul__(self)
        return self._value * other

    def __truediv__(self, other):
        if isinstance(other, SignedBinary):
            return SignedBinary(self._value // other._value)
        if isinstance(other, QFloatBase):
            return other.__rtruediv__(self)
        return self._value / other

    def __neg__(self):
        return SignedBinary(-1 * self._value)

    def neg(self):
        self._value = self._value * -1
        return self

    def __abs__(self):
        return SignedBinary(abs(self._value))


class QFloatBase:
    """Common interface + derived operators of every QFloat cell type.

    Concrete types: ``ops.packed.PackedQFloat`` (int64 tensors) and
    ``ops.emit.EmitQFloat`` (records C++ for the CUDA kernel body).
    """

    # Op statistics of the circuit being built or run (reference
    # qfloat.py:262-265): process globals, one count per QFloat op.
    ADDITIONS = 0
    MULTIPLICATION = 0
    DIVISION = 0

    _ints: int
    _base: int

    @classmethod
    def reset_stats(cls):
        QFloatBase.ADDITIONS = 0
        QFloatBase.MULTIPLICATION = 0
        QFloatBase.DIVISION = 0

    @classmethod
    def show_stats(cls):
        print("\nQFloat statistics :")
        print("======================")
        print("Additions       : " + str(QFloatBase.ADDITIONS))
        print("Multiplications : " + str(QFloatBase.MULTIPLICATION))
        print("Divisions       : " + str(QFloatBase.DIVISION))
        print("\n")

    @property
    def ints(self):
        return self._ints

    @property
    def base(self):
        return self._base

    @property
    def sign(self):
        return self._sign

    @property
    def frac(self):
        return len(self) - self._ints

    # ---- derived operators (reference qfloat.py:692-778, 836-953) ---------
    def __add__(self, other):
        addition = self.copy()
        addition += other
        return addition

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        res = -other
        res += self
        return res

    def __rsub__(self, other):
        res = -self
        res += other
        return res

    def __mul__(self, other):
        if isinstance(other, Zero):
            return Zero()
        multiplication = self.copy()
        multiplication *= other
        return multiplication

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        division = self.copy()
        division /= other
        return division

    def __rtruediv__(self, other):
        if isinstance(other, Zero):
            return Zero()
        if isinstance(other, SignedBinary):
            # the value is also its sign (reference qfloat.py:1252-1256)
            return self.invert(other.value, len(self), self._ints)
        if isinstance(other, QFloatBase):
            return other / self
        raise ValueError("Unknown class for other")

    def __neg__(self):
        neg = self.copy()
        neg._sign = neg._sign * -1
        return neg

    def neg(self):
        self._sign = self._sign * -1
        return self

    def __abs__(self):
        absval = self.copy()
        absval._sign = absval._sign * absval._sign  # stays 0 if 0
        return absval

    def __lt__(self, other):
        return other > self

    def __le__(self, other):
        return 1 - (self > other)

    def __ge__(self, other):
        return 1 - (other > self)

    def check_compatibility(self, other):
        """Reference qfloat.py:591-605."""
        if not isinstance(other, QFloatBase):
            raise ValueError("Object must also be a QFloat")
        if self._base != other.base:
            raise ValueError("QFloats bases are different")
        if len(self) != len(other):
            raise ValueError("QFloats have different length")
        if self._ints != other.ints:
            raise ValueError("QFloats have different dot index")


def check_invert_sign(sign):
    if not (
        isinstance(sign, SignedBinary)
        or (isinstance(sign, numbers.Integral) and abs(sign) == 1)
    ):
        raise ValueError("sign must be a SignedBinary or a signed binary scalar")


def qf_from_mul(a, b, newlength=None, newints=None):
    """Windowed multiply dispatched to the QFloat type among the operands."""
    for x in (a, b):
        if isinstance(x, QFloatBase):
            return type(x).from_mul(a, b, newlength, newints)
    if isinstance(a, Zero) or isinstance(b, Zero):
        return Zero()
    return a * b
