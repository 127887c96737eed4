"""Zero / SignedBinary / QFloatBase, the static number-type layer, and
QFloat, the digit-array ("limb") backend for any base.

Port of ``matrix_inversion_tpu/core/qfloat.py:61-822`` with the same
meaning, the op counters (``:189-210``) included.  ``Zero`` and
``SignedBinary`` are Python-level types whose dispatch prunes work while
the circuit is built: the static pruning is what fixes the op sequence, so
the eager PyTorch circuit and the CUDA kernel body emitted from it
(ops/emit.py) run the same ops as the reference.  Values inside
``SignedBinary`` and QFloat signs are Python ints, integer tensors, or
(while emitting) integer symbols; every operator used here works on all
three.

:class:`QFloat` holds int32 digit tensors, most significant digit first,
with any leading batch shape; its chains run in ``ops/limbs.py`` (on CUDA
tensors the long division in K6 and the carry chains in K7).  Its digits
stay int32 throughout: batched signs and factors are cast to int32 where
they multiply digits, which gives the values the JAX package computes in
int64 there.
"""

from __future__ import annotations

import functools
import numbers

import numpy as np
import torch

from ..ops import limbs, radix


class Zero:
    """Build-time-known zero; absorbs ops without emitting device work."""

    def copy(self):
        return self

    def to_float(self):
        return float(0)

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

    @value.setter
    def value(self, newvalue):
        self._value = newvalue

    @property
    def encrypted(self):
        """API parity with the JAX package, where it means "on the
        device": whether the value is a tensor."""
        return isinstance(self._value, torch.Tensor)

    def copy(self):
        return SignedBinary(self._value)

    def to_float(self):
        v = self._value
        if isinstance(v, torch.Tensor):
            return v.cpu().numpy().astype(float)
        return float(v)

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

    Concrete types: :class:`QFloat` (digit arrays, any base),
    ``ops.packed.PackedQFloat`` (int64 magnitudes) and
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

    def abs(self):
        self._sign = self._sign * self._sign
        return self

    def __lt__(self, other):
        return other > self

    def __le__(self, other):
        return 1 - (self > other)

    def __ge__(self, other):
        return 1 - (other > self)

    @classmethod
    def check_convert_fhe(cls, qfloat, condition):
        """No-op kept for API parity (reference qfloat.py:780-789): torch
        has no clear and encrypted operands to promote between."""
        return None

    def self_check_convert_fhe(self, condition):
        """No-op kept for API parity (reference qfloat.py:791-796)."""
        return None

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


DIGIT_DTYPE = limbs.DIGIT_DTYPE


def _is_number_like(x) -> bool:
    """Scalar or batched plain-number operand (reference: Tracer or Integral)."""
    return isinstance(x, (numbers.Integral, torch.Tensor, np.ndarray))


def _sign_of(x):
    if isinstance(x, numbers.Number):
        return int(np.sign(x))
    return torch.sign(torch.as_tensor(x))


def _dfac(x):
    """A batched int factor against a digit axis: int32, with the digit axis
    appended; a Python int as it is."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        x = torch.as_tensor(x).to(DIGIT_DTYPE)
        return x[..., None] if x.dim() > 0 else x
    return x


@functools.lru_cache(maxsize=None)
def _unit_row(length, device):
    """``[1, 0, ..., 0]`` of ``length`` int32 digits on ``device``, filled
    once and kept: a reciprocal's dividend, which no caller writes.  On a
    card the fill is waited for, so that kernels on any stream may read it."""
    row = torch.zeros(length, dtype=DIGIT_DTYPE, device=device)
    row[0] = 1
    if row.is_cuda:
        torch.cuda.current_stream(row.device).synchronize()
    return row


class QFloat(QFloatBase):
    """Digit-array QFloat (any base), batched over leading dims.

    Storage: ``_array`` int32[..., L] (most significant digit first),
    ``_sign`` an int or an integer tensor of the batch shape, static
    ``_ints``/``_base`` and the ``_is_base_tidy`` deferred-normalization flag
    (reference qfloat.py:267-305).
    """

    def __init__(self, array, ints=None, base=2, is_base_tidy=True, sign=1):
        if not isinstance(array, (torch.Tensor, np.ndarray)):
            raise ValueError("array must be a torch tensor or a numpy array")
        array = torch.as_tensor(array).to(DIGIT_DTYPE)
        if array.dim() < 1:
            raise ValueError("array must have a digit axis")
        self._array = array

        if not (isinstance(base, int) and base > 1):
            raise ValueError("base must be a int >1")
        self._base = base

        length = array.shape[-1]
        if ints is None:
            ints = length // 2
        elif not (isinstance(ints, (int, np.integer)) and 0 <= ints <= length):
            raise ValueError("ints must be in range [0,array length]")
        self._ints = int(ints)

        if isinstance(sign, float):
            sign = int(sign)
        self._sign = sign

        self._is_base_tidy = is_base_tidy
        if not self._is_base_tidy:
            self.base_tidy()

    # ---- shape ------------------------------------------------------------
    def __len__(self):
        return int(self._array.shape[-1])

    @property
    def bshape(self):
        """Leading batch shape."""
        return self._array.shape[:-1]

    @property
    def device(self):
        return self._array.device

    @property
    def array(self):
        return self._array

    @property
    def is_base_tidy(self):
        return self._is_base_tidy

    @property
    def encrypted(self):
        """API parity with the JAX package, where it means "on the
        device": always True, the digits are a tensor."""
        return isinstance(self._array, torch.Tensor)

    # ---- host conversions (reference qfloat.py:336-410) -------------------
    @classmethod
    def from_float(cls, f, length=10, ints=None, base=2):
        """(Batched) floats quantized on the host (``ops/radix.py``: an
        integer part wider than ``ints`` digits keeps its low digits)."""
        if ints is None:
            ints = length // 2
        digits, sign = radix.float_to_digits_and_sign(f, length, ints, base)
        sign = int(sign) if np.ndim(sign) == 0 else torch.from_numpy(sign)
        return cls(torch.from_numpy(digits), ints, base, True, sign)

    def to_float(self):
        """The value as float64 numpy, on the host."""
        sign = self._sign.cpu().numpy() if isinstance(self._sign, torch.Tensor) else self._sign
        return radix.digits_and_sign_to_float(
            self._array.cpu().numpy(), np.asarray(sign), self._ints, self._base)

    def to_str(self, tidy=True):
        """Reference qfloat.py:336-365 (unbatched only)."""
        if self.bshape != ():
            raise ValueError("to_str works on unbatched QFloats only")
        if tidy:
            self.base_tidy()
        sgn = int(self._sign)
        arr = self._array.cpu().numpy() * (sgn != 0)
        integer_part = arr[: self._ints].astype(int)
        float_part = arr[self._ints:].astype(int)
        if self._base <= 10:
            integer_part = "".join(str(i) for i in integer_part)
            float_part = "".join(str(i) for i in float_part)
        else:
            integer_part = str(integer_part)
            float_part = str(float_part)
        sgnstr = "" if sgn >= 0 else "-"
        return sgnstr + integer_part + "." + float_part

    def __str__(self):
        return self.to_str(True)

    # ---- factories (reference qfloat.py:502-546) --------------------------
    @classmethod
    def zero(cls, length, ints, base, bshape=(), device=None):
        return cls(torch.zeros(tuple(bshape) + (length,), dtype=DIGIT_DTYPE, device=device),
                   ints, base, True, 1)

    @classmethod
    def zero_like(cls, other):
        return cls.zero(len(other), other.ints, other.base, other.bshape, other.device)

    @classmethod
    def one(cls, length, ints, base, bshape=(), device=None):
        arr = torch.zeros(tuple(bshape) + (length,), dtype=DIGIT_DTYPE, device=device)
        arr[..., ints - 1] = 1
        return cls(arr, ints, base, True, 1)

    @classmethod
    def one_like(cls, other):
        return cls.one(len(other), other.ints, other.base, other.bshape, other.device)

    def copy(self):
        return QFloat(self._array, self._ints, self._base, self._is_base_tidy, self._sign)

    def to_array(self):
        return self._array

    def to_digits(self):
        """Uniform digit accessor shared with the packed backend."""
        return self._array

    def set_len_ints(self, newlen, newints):
        """Resize/crop the encoding (reference qfloat.py:565-589, with the
        JAX package's crop of leading integer digits)."""
        arr = self._array
        if self._ints != newints:
            if newints > self._ints:
                pad = arr.new_zeros(arr.shape[:-1] + (int(newints - self._ints),))
                arr = torch.cat([pad, arr], dim=-1)
            else:
                arr = arr[..., self._ints - newints:]
            self._ints = int(newints)
        difflen = int(newlen) - arr.shape[-1]
        if difflen != 0:
            if difflen > 0:
                arr = torch.cat([arr, arr.new_zeros(arr.shape[:-1] + (difflen,))], dim=-1)
            else:
                arr = arr[..., :difflen]
        self._array = arr
        return self

    # ---- normalization (reference qfloat.py:607-673) ----------------------
    def base_tidy(self):
        if self._is_base_tidy:
            return
        self._array = limbs.base_tidy(self._array, self._base)
        self._is_base_tidy = True

    @classmethod
    def multi_base_tidy(cls, arrays, base):
        return limbs.base_tidy(arrays, base)

    def tidy(self):
        if not self._is_base_tidy:
            self.base_tidy()
        self._array, self._sign = limbs.tidy_to_sign_mag(self._array, self._base)

    # ---- comparisons (reference qfloat.py:681-749) ------------------------
    def __eq__(self, other):
        self.check_compatibility(other)
        if not (self._is_base_tidy and other._is_base_tidy):
            raise Exception("cannot compare QFloats that are not tidy")
        return limbs.is_equal(self._array, other._array) * (self._sign == other._sign)

    __hash__ = None

    def __gt__(self, other):
        self.check_compatibility(other)
        self.base_tidy()
        other.base_tidy()
        sgn_eq = (self._sign == other._sign) * 1
        self_gt_other = 1 - limbs.is_greater_or_equal(other._array, self._array)
        inverse = ((self._sign < 0) * 1) * (1 - limbs.is_equal(self._array, other._array))
        return sgn_eq * (self_gt_other ^ inverse) + (1 - sgn_eq) * (
            (self._sign > other._sign) * 1
        )

    # ---- addition (reference qfloat.py:798-834) ---------------------------
    def __iadd__(self, other):
        if isinstance(other, Zero):
            return self  # (the reference returns None here)

        QFloatBase.ADDITIONS += 1

        arr = self._array * _dfac(self._sign)  # a new tensor; 0 where the sign is 0
        if isinstance(other, (SignedBinary, numbers.Integral, torch.Tensor, np.ndarray)):
            value = other.value if isinstance(other, SignedBinary) else other
            arr[..., self._ints - 1] += torch.as_tensor(value, device=arr.device).to(DIGIT_DTYPE)
        else:
            self.check_compatibility(other)
            arr = arr + other._array * _dfac(other._sign)
        # base_tidy then the sign: one K7 launch on a CUDA tensor
        self._array, self._sign = limbs.tidy_to_sign_mag(arr, self._base)
        self._is_base_tidy = True
        return self

    # ---- multiplication (reference qfloat.py:852-930, 955-1181) -----------
    def __imul__(self, other):
        if _is_number_like(other):
            sign = _sign_of(other)
            self._array = self._array * _dfac(other * sign)
            self._sign = self._sign * sign
            self._is_base_tidy = False
            self.base_tidy()
        elif isinstance(other, SignedBinary):
            # multiplying by a binary is a sign multiply (reference :867-871)
            self._sign = self._sign * other.value
        else:
            QFloatBase.MULTIPLICATION += 1
            self.base_tidy()
            other.base_tidy()
            self.check_compatibility(other)
            self._array = _mul_window(self._array, self._ints, other._array, other.ints,
                                      len(self), self._ints)
            self._sign = self._sign * other._sign
            self._is_base_tidy = False
            self.base_tidy()
        return self

    @classmethod
    def from_mul(cls, a, b, newlength=None, newints=None):
        """Windowed multiply into a chosen output format.

        Digit-exact with reference qfloat.py:955-1021 including the
        per-partial-product cropping (sub-window digits of each partial
        product are dropped before the sum, so this is intentionally not a
        pure value function of (a, b)).
        """
        if newlength is None:
            newlength = len(a)
        if newints is None:
            newints = a.ints

        if isinstance(a, Zero) or isinstance(b, Zero):
            return Zero()

        if isinstance(a, SignedBinary) or isinstance(b, SignedBinary):
            if isinstance(a, SignedBinary) and isinstance(b, SignedBinary):
                return a * b
            multiplication = a * b
            multiplication.set_len_ints(newlength, newints)
            return multiplication

        QFloatBase.MULTIPLICATION += 1
        assert a.is_base_tidy
        assert b.is_base_tidy
        if not a.base == b.base:
            raise ValueError("bases are different")

        cols = _mul_window(a.array, a.ints, b.array, b.ints, newlength, newints)
        return QFloat(cols, newints, a.base, False, a.sign * b.sign)

    @classmethod
    def multi_from_mul(cls, list_a, list_b, newlength=None, newints=None):
        """Grouped multiply of element pairs (reference qfloat.py:1023-1181).

        QFloat x QFloat pairs are stacked on a new leading axis and run
        through one windowed multiply and one batched tidy; Zero and
        SignedBinary pairs take their static fast paths.  Results equal
        per-pair :meth:`from_mul`'s.
        """
        a0 = next((a for a in list_a if isinstance(a, QFloatBase)), None)
        b0 = next((b for b in list_b if isinstance(b, QFloatBase)), None)
        if newlength is None:
            newlength = len(a0) if a0 is not None else len(b0)
        if newints is None:
            newints = a0.ints if a0 is not None else b0.ints
        assert len(list_a) == len(list_b)

        list_ab = [None] * len(list_a)
        idx_qf = []
        for i, (a, b) in enumerate(zip(list_a, list_b)):
            if isinstance(a, Zero) or isinstance(b, Zero):
                list_ab[i] = Zero()
            elif isinstance(a, SignedBinary) or isinstance(b, SignedBinary):
                if isinstance(a, SignedBinary) and isinstance(b, SignedBinary):
                    list_ab[i] = a * b
                else:
                    ab = a * b
                    ab.set_len_ints(newlength, newints)
                    list_ab[i] = ab
            else:
                idx_qf.append(i)

        QFloatBase.MULTIPLICATION += len(idx_qf)
        if not idx_qf:
            return list_ab
        for i in idx_qf:
            assert list_a[i].is_base_tidy and list_b[i].is_base_tidy

        a_stack = torch.stack([list_a[i].array for i in idx_qf], dim=0)
        b_stack = torch.stack([list_b[i].array for i in idx_qf], dim=0)
        cols = _mul_window(a_stack, a0.ints, b_stack, b0.ints, newlength, newints)
        cols = limbs.base_tidy(cols, a0.base)
        for k, i in enumerate(idx_qf):
            list_ab[i] = QFloat(cols[k], newints, a0.base, True, list_a[i].sign * list_b[i].sign)
        return list_ab

    # ---- division (reference qfloat.py:1183-1376) -------------------------
    def __itruediv__(self, other):
        if isinstance(other, Zero):
            raise ValueError("division by Zero")

        if isinstance(other, SignedBinary):
            # signed pass-through; dividing by 0 saturates (reference
            # qfloat.py:1199-1210)
            v = other.value
            is_zero = (v == 0) * 1
            sat = torch.full(self._array.shape, self._base - 1, dtype=DIGIT_DTYPE,
                             device=self._array.device)
            iz = _dfac(is_zero)
            self._array = (1 - iz) * self._array + iz * sat
            self._sign = (1 - is_zero) * v + is_zero * self._sign
            return self

        assert other.is_base_tidy
        QFloatBase.DIVISION += 1
        self.check_compatibility(other)
        assert self._is_base_tidy

        fp = len(self) - self._ints
        zeros = self._array.new_zeros(self._array.shape[:-1] + (fp,))
        shift_arr = torch.cat([self._array, zeros], dim=-1)
        div_array = limbs.base_p_division(shift_arr, other._array, self._base)
        self._sign = self.sign * other.sign
        self._array = div_array[..., fp:]
        return self

    def invert(self, sign=1, newlength=None, newints=None):
        """Signed reciprocal at a chosen output format (reference
        qfloat.py:1263-1309): ``1`` left-shifted by the old and the new
        fraction precision, divided by this QFloat's digits, then cropped or
        padded to ``newlength``."""
        check_invert_sign(sign)
        QFloatBase.DIVISION += 1
        assert self._is_base_tidy

        if newlength is None:
            newlength = len(self)
        if newints is None:
            newints = self._ints

        fp = newlength - newints
        fpself = len(self) - self._ints
        div_array = limbs.base_p_division(_unit_row(1 + fpself + fp, self._array.device),
                                          self._array, self._base)
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return QFloat(_fit_length(div_array, newlength), newints, self._base, True,
                      sb * self.sign)

    @classmethod
    def multi_invert(cls, list_qfloats, sign=1, newlength=None, newints=None):
        """Grouped reciprocal (reference qfloat.py:1311-1376)."""
        check_invert_sign(sign)
        qf0 = list_qfloats[0]
        for q in list_qfloats:
            assert isinstance(q, cls) and q.is_base_tidy
            assert len(q) == len(qf0) and q.base == qf0.base and q.ints == qf0.ints
        QFloatBase.DIVISION += len(list_qfloats)

        if newlength is None:
            newlength = len(qf0)
        if newints is None:
            newints = qf0.ints

        b_stack = torch.stack([q.array for q in list_qfloats], dim=0)
        fp = newlength - newints
        fpself = len(qf0) - qf0.ints
        div_array = limbs.base_p_division(_unit_row(1 + fpself + fp, b_stack.device), b_stack,
                                          qf0.base)
        div_array = _fit_length(div_array, newlength)
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return [
            QFloat(div_array[i], newints, qf0.base, True, sb * q.sign)
            for i, q in enumerate(list_qfloats)
        ]

    # ---- pivot support ----------------------------------------------------
    def blend_from(self, other, cond):
        """Branchless magnitude select used by the pivot argmax.

        Deliberately bug-compatible with reference qfloat.py:323-326
        (``qfloat_argmax``): the sign is NOT blended, only the digits.
        """
        c = _dfac(cond)
        self._array = c * other._array + (1 - c) * self._array
        return self


def _fit_length(div_array, newlength):
    """A reciprocal's quotient digits padded on the left or cropped to the
    trailing ``newlength``."""
    diff = newlength - div_array.shape[-1]
    if diff > 0:
        pad = div_array.new_zeros(div_array.shape[:-1] + (diff,))
        return torch.cat([pad, div_array], dim=-1)
    if diff < 0:
        return div_array[..., -newlength:]
    return div_array


def _mul_window(a, a_ints, b, b_ints, newlength, newints):
    """Column sums of the cropped partial-product array (reference
    qfloat.py:995-1016): partial product row i (``a[i] * b``) is shifted to
    output position ``indb = newints - a_ints + i + 1 - b_ints`` and cropped
    to the output window before the sum.  Returns the untidy column sums,
    one slice add a row of ``a``."""
    la = a.shape[-1]
    lb = b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros(batch + (newlength,), dtype=a.dtype, device=a.device)
    for i in range(la):
        indb = newints - a_ints + i + 1 - b_ints
        ind1 = 0 if indb >= 0 else -indb
        ind2 = min(lb, newlength - indb)
        if ind2 > ind1:
            out[..., indb + ind1:indb + ind2] += a[..., i:i + 1] * b[..., ind1:ind2]
    return out


def check_invert_sign(sign):
    if not (
        isinstance(sign, SignedBinary)
        or (isinstance(sign, numbers.Integral) and abs(sign) == 1)
    ):
        raise ValueError("sign must be a SignedBinary or a signed binary scalar")


def qf_class_of(*xs):
    """The QFloat type among the operands, or in their lists, or None."""
    for x in xs:
        if isinstance(x, QFloatBase):
            return type(x)
    for x in xs:
        for y in x if isinstance(x, (list, tuple)) else ():
            if isinstance(y, QFloatBase):
                return type(y)
    return None


def qf_multi_from_mul(list_a, list_b, newlength=None, newints=None):
    """Grouped windowed multiply of element pairs, by the QFloat type's
    ``multi_from_mul``.  A type without one (the emitter's) multiplies pair
    by pair, into the format ``multi_from_mul`` would choose: that of the
    first QFloat of ``list_a``, else of ``list_b``."""
    cls = qf_class_of(list_a, list_b)
    if cls is None:
        return [qf_from_mul(a, b, newlength, newints) for a, b in zip(list_a, list_b)]
    if hasattr(cls, "multi_from_mul"):
        return cls.multi_from_mul(list_a, list_b, newlength, newints)
    first = next(x for x in (*list_a, *list_b) if isinstance(x, QFloatBase))
    newlength = len(first) if newlength is None else newlength
    newints = first.ints if newints is None else newints
    return [qf_from_mul(a, b, newlength, newints) for a, b in zip(list_a, list_b)]


def qf_multi_invert(list_qfloats, sign=1, newlength=None, newints=None):
    """Grouped reciprocal by the QFloat type's ``multi_invert``, else one
    ``invert`` each."""
    cls = qf_class_of(list_qfloats)
    if not hasattr(cls, "multi_invert"):
        return [q.invert(sign, newlength, newints) for q in list_qfloats]
    return cls.multi_invert(list_qfloats, sign, newlength, newints)


def qf_from_mul(a, b, newlength=None, newints=None):
    """Windowed multiply dispatched to the QFloat type among the operands."""
    for x in (a, b):
        if isinstance(x, QFloatBase):
            return type(x).from_mul(a, b, newlength, newints)
    if isinstance(a, Zero) or isinstance(b, Zero):
        return Zero()
    return a * b
