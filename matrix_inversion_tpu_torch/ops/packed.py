"""PackedQFloat on int64 torch tensors: the eager path and the kernel's spec.

Port of ``matrix_inversion_tpu/ops/packed.py`` (``:52-139,164-645,
650-798,842-969``), overflow tracking included.  A base-tidy QFloat with a power-of-two
base and ``base**len < 2**62`` is exactly ``(magnitude, sign)``: the
magnitude an int64 tensor, the sign a Python int or an int64 tensor in
{-1, 0, +1} (sign 0 makes the value act as zero).

int64 stands in for the JAX module's uint64: magnitudes stay below 2**62,
so signed shifts and compares equal the unsigned ones, and int64 products
wrap mod 2**64 exactly like the reference's uint64 partial sums before the
final ``& mask``.

Division (:func:`packed_long_division`) is routed as in the JAX module.
A CUDA tensor divides through a hand-written kernel
(``ops/long_division.py``): K2, the f32-estimate long division, where
:func:`_float_div_chunk_bits` allows it, else K3, the restoring long
division.  A CPU tensor divides through the plain version
:func:`packed_long_division_reference`, one exact ``torch.div`` floor
division.  All give the same bits, a zero divisor included: it saturates
the ``n_bits`` window to all ones, as the restoring loop does (reference
base_p_arrays.py:189-201).  ``set_division_impl("classic")`` forces K3.
Untracked base-2 multiplies of CUDA tensors go through the windowed-multiply
kernel K4; CPU tensors take the truncated form.  Inside
:func:`plain_arithmetic` every tensor takes the plain versions.

Inside a ``track_overflow()`` scope every normalization records whether
it dropped digits past the top of its window, and multiplies take the
windowed form (:func:`mul_window_packed`), whose mod-2**64 partial sum
exposes exactly the carries the JAX package flags; outside it they take
the algebraic truncated form (:func:`mul_trunc_packed`).  Both give the
same magnitudes.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from ..core.qfloat import QFloatBase, SignedBinary, Zero, check_invert_sign

MAG_DTYPE = torch.int64

# The live tracker of the innermost track_overflow() scope, or None.
_OVERFLOW_TRACKER = None

# Division lowering: None (the float-estimate form where it applies) or
# "classic" (one digit per restoring step).
_DIVISION_IMPL = None

# Per thread: inside plain_arithmetic(), divisions and multiplies take their
# plain versions on every device.
_PLAIN = threading.local()


class _Setting:
    """Sets a module switch when made; as a ``with`` scope, restores the
    previous value on exit."""

    def __init__(self, name, value, allowed):
        if value not in allowed:
            raise ValueError(f"{name.strip('_').lower()} must be one of {allowed}, got {value!r}")
        self._name = name
        self._prev = globals()[name]
        globals()[name] = value

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        globals()[self._name] = self._prev
        return False


def set_division_impl(impl):
    """Force the division lowering: None (the float-estimate form, K2 on
    CUDA, where :func:`_float_div_chunk_bits` allows it, else the restoring
    loop) or "classic" (the restoring loop, K3 on CUDA).  The counterpart of
    the JAX package's ``set_division_impl``, whose "float" is None here.
    Usable as a ``with`` scope."""
    return _Setting("_DIVISION_IMPL", impl, (None, "classic"))


@contextlib.contextmanager
def plain_arithmetic():
    """Scope in which this thread's divisions and multiplies take their
    plain versions on every device: the plain version of K1 and of the
    op-by-op path."""
    prev = getattr(_PLAIN, "on", False)
    _PLAIN.on = True
    try:
        yield
    finally:
        _PLAIN.on = prev


def _to_kernel(t):
    """Whether an op on ``t`` launches a kernel: a CUDA tensor outside
    :func:`plain_arithmetic`."""
    return t.device.type == "cuda" and not getattr(_PLAIN, "on", False)


class OverflowTracker:
    """The overflow flags recorded inside one ``track_overflow()`` scope."""

    def __init__(self):
        self.flags = []

    def record(self, flag):
        self.flags.append(flag)

    def combined(self, batch_shape=None, device=None):
        """OR of all recorded flags as int32 of ``batch_shape``; extra
        leading axes are any-reduced.  No flag at all gives zeros on
        ``device`` (the device of the scope's operands, which only the
        caller knows then; default: PyTorch's default device); recorded
        flags carry their own device."""
        if not self.flags:
            return torch.zeros(batch_shape or (), dtype=torch.int32, device=device)
        if batch_shape is None:
            batch_shape = min((f.shape for f in self.flags), key=len)
        out = torch.zeros(batch_shape, dtype=torch.bool, device=self.flags[0].device)
        for f in self.flags:
            while f.dim() > len(batch_shape):
                f = f.any(dim=0)
            out = out | f
        return out.to(torch.int32)


class track_overflow:
    """Scope in which QFloat ops record their overflow flags."""

    def __enter__(self):
        global _OVERFLOW_TRACKER
        self._prev = _OVERFLOW_TRACKER
        _OVERFLOW_TRACKER = OverflowTracker()
        return _OVERFLOW_TRACKER

    def __exit__(self, *exc):
        global _OVERFLOW_TRACKER
        _OVERFLOW_TRACKER = self._prev
        return False


def digit_bits(base: int) -> int:
    if base < 2 or base & (base - 1):
        raise ValueError("packed backend requires a power-of-two base")
    return base.bit_length() - 1


def _digit_shifts(length, bits, device):
    """``bits * (L-1-j)`` for j = 0..L-1: the place of digit j, most
    significant first."""
    return torch.arange(bits * (length - 1), -1, -bits, dtype=MAG_DTYPE, device=device)


def digits_to_mags(digits, bits):
    """``(..., L)`` digits -> ``(...)`` int64 magnitudes
    ``sum_j digit_j * 2**(bits*(L-1-j))``: one shift and one sum."""
    digits = torch.as_tensor(digits).to(MAG_DTYPE)
    return (digits << _digit_shifts(digits.shape[-1], bits, digits.device)).sum(-1)


def mags_to_digits(mags, length, bits, out=None):
    """``(...)`` int64 magnitudes -> ``(..., length)`` int32 digits
    ``(mag >> bits*(L-1-j)) & (2**bits - 1)``: one shift, then the mask
    and the cast in one pass into ``out`` (allocated if None; it may be a
    view, such as the digit columns of a wider output).  Magnitudes are
    below 2**62, so int64 shifts equal the reference's uint64 ones."""
    if out is None:
        out = torch.empty(mags.shape + (length,), dtype=torch.int32, device=mags.device)
    wide = mags.unsqueeze(-1) >> _digit_shifts(length, bits, mags.device)
    return torch.bitwise_and(wide, (1 << bits) - 1, out=out)


@functools.lru_cache(maxsize=None)
def _constant_word(value, device):
    """A 0-dim int64 tensor holding ``value``, filled on ``device`` once and
    kept: a reciprocal's dividend, which no caller writes.  On a card the
    fill is waited for, so that kernels on any stream may read it."""
    word = torch.full((), value, dtype=MAG_DTYPE, device=device)
    if word.is_cuda:
        torch.cuda.current_stream(word.device).synchronize()
    return word


def _sign_tensor(sign, like):
    """Sign (Python int or tensor) as an int64 tensor broadcastable to ``like``."""
    if isinstance(sign, torch.Tensor):
        return sign
    return torch.full_like(like, int(sign))


class PackedQFloat(QFloatBase):
    """int64-magnitude QFloat (power-of-two bases, ``base**len < 2**62``)."""

    def __init__(self, mag, length, ints=None, base=2, sign=1):
        self._length = int(length)
        if ints is None:
            ints = length // 2
        self._ints = int(ints)
        if not (0 <= self._ints <= self._length):
            raise ValueError("ints must be in range [0, length]")
        self._base = int(base)
        self._bits = digit_bits(self._base)
        if self._bits * self._length > 62:
            raise ValueError("encoding too wide for the packed backend")
        self._mag = torch.as_tensor(mag, dtype=MAG_DTYPE)
        self._sign = sign

    # ---- shape / metadata -------------------------------------------------
    def __len__(self):
        return self._length

    @property
    def bshape(self):
        return self._mag.shape

    @property
    def mag(self):
        return self._mag

    def _mask(self, ndigits=None):
        n = self._length if ndigits is None else ndigits
        return (1 << (self._bits * n)) - 1

    # ---- conversions (matrix_inversion_tpu/ops/packed.py:219-249) ---------
    @classmethod
    def from_digits(cls, digits, ints=None, base=2, sign=1):
        """Pack a digit tensor ``[..., L]`` into magnitudes."""
        return cls(digits_to_mags(digits, digit_bits(base)), digits.shape[-1], ints, base, sign)

    def to_digits(self):
        """Unpack the magnitudes into an int32 digit tensor ``[..., L]``."""
        return mags_to_digits(self._mag, self._length, self._bits)

    def to_array(self):
        return self.to_digits()

    def to_float(self):
        """The value as float64 numpy, on the host."""
        scale = float(self._base) ** (-(self._length - self._ints))
        sign = self._sign.cpu() if isinstance(self._sign, torch.Tensor) else self._sign
        return self._mag.cpu().numpy().astype(np.float64) * scale * np.asarray(sign, np.float64)

    def copy(self):
        return PackedQFloat(self._mag, self._length, self._ints, self._base, self._sign)

    def set_len_ints(self, newlen, newints):
        """Crop/pad semantics of reference qfloat.py:565-589 on magnitudes."""
        mag = self._mag
        length = self._length
        if self._ints != newints:
            if newints < self._ints:
                # drop leading (ints - newints) digits -> mod base**remaining
                length = length - (self._ints - newints)
                mag = mag & self._mask(length)
            else:
                length = length + (newints - self._ints)
            self._ints = int(newints)
        difflen = int(newlen) - length
        if difflen > 0:
            mag = mag << (self._bits * difflen)
        elif difflen < 0:
            mag = mag >> (self._bits * (-difflen))
        self._length = int(newlen)
        self._mag = mag
        return self

    def _tidy_signed(self, v):
        """Signed value -> (mag, sign): overflow past the top digit is
        dropped (mod base**L on |v|), the sign of zero is +1
        (reference qfloat.py:607-673).  A live tracker records the
        dropped carry."""
        av = v.abs()
        mag = av & self._mask()
        sign = torch.where((v < 0) & (mag != 0), -1, 1)
        if _OVERFLOW_TRACKER is not None:
            _OVERFLOW_TRACKER.record(av > self._mask())
        return mag, sign

    # ---- comparisons ------------------------------------------------------
    def __eq__(self, other):
        self.check_compatibility(other)
        ss = _sign_tensor(self._sign, self._mag)
        os_ = _sign_tensor(other._sign, other._mag)
        return ((self._mag == other._mag) & (ss == os_)).to(MAG_DTYPE)

    __hash__ = None

    def __gt__(self, other):
        """Reference qfloat.py:711-739 in select form."""
        self.check_compatibility(other)
        ss = _sign_tensor(self._sign, self._mag)
        os_ = _sign_tensor(other._sign, other._mag)
        inverse = (ss < 0) & (self._mag != other._mag)
        gt = torch.where(ss == os_, (self._mag > other._mag) ^ inverse, ss > os_)
        return gt.to(MAG_DTYPE)

    # ---- addition ---------------------------------------------------------
    def __iadd__(self, other):
        if isinstance(other, Zero):
            return self
        QFloatBase.ADDITIONS += 1
        # sign in {-1, 0, +1}: mag * sign is the signed value
        v = self._mag * self._sign
        if isinstance(other, SignedBinary):
            v = v + (1 << (self._bits * (self._length - self._ints))) * other.value
        elif isinstance(other, PackedQFloat):
            self.check_compatibility(other)
            v = v + other._mag * other._sign
        else:
            raise TypeError(f"cannot add {type(other).__name__} to a PackedQFloat")
        self._mag, self._sign = self._tidy_signed(v)
        return self

    # ---- multiplication ---------------------------------------------------
    def __imul__(self, other):
        if isinstance(other, SignedBinary):
            self._sign = self._sign * other.value
        elif isinstance(other, PackedQFloat):
            # identical to from_mul at the same format
            QFloatBase.MULTIPLICATION += 1
            self.check_compatibility(other)
            self._mag = _mul_packed(
                self._mag, self._length, self._ints,
                other._mag, other._length, other._ints,
                self._length, self._ints, self._bits,
            )
            self._sign = self._sign * other._sign
        else:
            raise TypeError(f"cannot multiply a PackedQFloat by {type(other).__name__}")
        return self

    @classmethod
    def from_mul(cls, a, b, newlength=None, newints=None):
        """Windowed multiply; digit-exact with reference qfloat.py:955-1021."""
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
        if not a.base == b.base:
            raise ValueError("bases are different")
        mag = _mul_packed(
            a._mag, a._length, a.ints, b._mag, b._length, b.ints,
            newlength, newints, a._bits,
        )
        return cls(mag, newlength, newints, a.base, a.sign * b.sign)

    # ---- division ---------------------------------------------------------
    def __itruediv__(self, other):
        if isinstance(other, Zero):
            raise ValueError("division by Zero")
        if isinstance(other, SignedBinary):
            # unchanged or saturated (reference qfloat.py:1199-1210)
            v = other.value
            if isinstance(v, int):
                if v == 0:
                    self._mag = torch.full_like(self._mag, self._mask())
                else:
                    self._sign = v
                return self
            is_zero = v == 0
            self._mag = torch.where(is_zero, self._mask(), self._mag)
            self._sign = torch.where(is_zero, _sign_tensor(self._sign, v), v)
            return self

        QFloatBase.DIVISION += 1
        self.check_compatibility(other)
        fp = self._length - self._ints
        n_digits = self._length + fp
        if self._bits * n_digits > 62:
            raise ValueError("division dividend too wide for packed backend")
        dividend = self._mag << (self._bits * fp)
        q = packed_long_division(dividend, other._mag, n_digits, self._bits,
                                 divisor_bits=self._bits * other._length)
        if _OVERFLOW_TRACKER is not None:
            # quotient digits beyond the kept window are dropped overflow
            _OVERFLOW_TRACKER.record((q >> (self._bits * self._length)) != 0)
        self._mag = q & self._mask()  # keep the trailing `length` digits
        self._sign = self.sign * other.sign
        return self

    def invert(self, sign=1, newlength=None, newints=None):
        """Signed reciprocal (reference qfloat.py:1263-1309)."""
        check_invert_sign(sign)
        QFloatBase.DIVISION += 1
        if newlength is None:
            newlength = self._length
        if newints is None:
            newints = self._ints
        fp = newlength - newints
        fpself = self._length - self._ints
        n_digits = 1 + fpself + fp
        if self._bits * n_digits > 62:
            raise ValueError("invert dividend too wide for packed backend")
        # one word on the device: the kernels read it from its address
        dividend = _constant_word(1 << (self._bits * (fpself + fp)), self._mag.device)
        q = packed_long_division(dividend, self._mag, n_digits, self._bits,
                                 divisor_bits=self._bits * self._length)
        if newlength < n_digits:
            if _OVERFLOW_TRACKER is not None:
                _OVERFLOW_TRACKER.record((q >> (self._bits * newlength)) != 0)
            q = q & ((1 << (self._bits * newlength)) - 1)
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return PackedQFloat(q, newlength, newints, self._base, sb * self.sign)

    # ---- pivot support ----------------------------------------------------
    def blend_from(self, other, cond):
        """Magnitude-only branchless select (reference qfloat.py:323-326).

        Deliberately bug-compatible: the sign is NOT blended, exactly like
        ``qfloat_argmax`` in the reference.
        """
        self._mag = torch.where(cond != 0, other._mag, self._mag)
        return self


def _float_div_chunk_bits(n_bits, divisor_bits):
    """Quotient bits per float-estimate step, or 0 if inapplicable
    (``matrix_inversion_tpu/ops/packed.py:661-675``).

    q_est < 2**16 keeps the kernels' partial products narrow; the
    remainder ``r < divisor * 2**k`` and ``q_est * divisor`` must stay
    below 2**62; and the downward-biased estimate's deficit 2**k * eps
    (eps < 2**-16) must stay under 1 so one add-back fixup is enough --
    k <= 15 keeps it below 1/2.
    """
    if divisor_bits is None:
        return 0
    k = min(15, 61 - divisor_bits, n_bits)
    return k if k >= 4 else 0


def packed_long_division(dividend, divisor, n_digits, bits, divisor_bits=None):
    """``dividend // divisor`` on int64 magnitudes, exact, with JAX's
    signature (``matrix_inversion_tpu/ops/packed.py:719-776``).

    ``n_digits`` base-``2**bits`` digits of dividend (and quotient);
    ``divisor_bits`` bounds the divisor's width and enables the
    float-estimate form (K2) with ``k = _float_div_chunk_bits(...)``
    quotient bits per step; without it, or under
    ``set_division_impl("classic")``, the restoring form (K3) runs.  A
    zero divisor saturates all ``bits * n_digits`` quotient bits.  A CPU
    tensor, or any tensor inside :func:`plain_arithmetic`, takes the plain
    version, which gives the same bits.
    """
    n_bits = bits * n_digits
    if not _to_kernel(divisor):
        return packed_long_division_reference(dividend, divisor, n_bits)
    from . import long_division

    k = _float_div_chunk_bits(n_bits, divisor_bits)
    if k and _DIVISION_IMPL != "classic":
        return long_division.batched_long_division_float(dividend, divisor, n_bits, k)
    return long_division.batched_long_division(dividend, divisor, n_digits, bits)


def packed_long_division_reference(dividend, divisor, n_bits):
    """Plain version of the division kernels: one exact floor division;
    a zero divisor saturates all ``n_bits`` quotient bits, digit-exact with
    the restoring loop of the reference (base_p_arrays.py:189-201)."""
    is_zero = divisor == 0
    q = torch.div(dividend, torch.where(is_zero, 1, divisor), rounding_mode="floor")
    return torch.where(is_zero, (1 << n_bits) - 1, q)


def mul_trunc_packed(a_mag, a_len, a_ints, b_mag, b_len, b_ints,
                     newlength, newints, bits):
    """The cropped partial-product sum of reference qfloat.py:995-1016.

    Algebraic form of ``matrix_inversion_tpu/ops/packed.py:842-865``: the
    digits of ``a`` at or above the crop share one wide multiply, each
    digit below it keeps its own floor.  Products wrap mod 2**64 in int64
    exactly as the reference's uint64 sums; the final mask keeps < 63 bits.
    """
    out_mask = (1 << (bits * newlength)) - 1
    t_dig = (a_len - a_ints) + (b_len - b_ints) - (newlength - newints)
    t1 = bits * t_dig
    if t1 <= 0:
        return ((a_mag * b_mag) << (-t1)) & out_mask
    acc = (a_mag >> t1) * b_mag
    base_mask = (1 << bits) - 1
    for p in range(max(0, t_dig - b_len + 1), min(t_dig, a_len)):
        w = b_mag >> (bits * (t_dig - p))
        a_p = (a_mag >> (bits * p)) & base_mask
        acc = acc + w * a_p
    return acc & out_mask


def _mul_packed(a_mag, a_len, a_ints, b_mag, b_len, b_ints, newlength, newints, bits):
    """The multiply of the circuit: windowed (and recorded) inside a
    ``track_overflow()`` scope, truncated outside it (the rule of
    ``matrix_inversion_tpu/ops/packed.py:880-912``); untracked at base 2
    on a CUDA tensor, the windowed-multiply kernel K4."""
    if _OVERFLOW_TRACKER is None:
        if bits == 1 and _to_kernel(a_mag):
            from . import long_division

            return long_division.batched_mul_window(
                a_mag, b_mag, a_len, a_ints, b_len, b_ints, newlength, newints)
        return mul_trunc_packed(a_mag, a_len, a_ints, b_mag, b_len, b_ints,
                                newlength, newints, bits)
    mag, flag = mul_window_packed(a_mag, a_len, a_ints, b_mag, b_len, b_ints,
                                  newlength, newints, bits)
    _OVERFLOW_TRACKER.record(flag)
    return mag


def mul_window_consts(a_len, a_ints, b_len, b_ints, newlength, newints, bits):
    """Per-digit ``(a_shift, b_shift, b_mask, out_shift)`` of the windowed
    multiply, one tuple per digit of ``a`` from the top; ``b_mask == 0``
    marks a digit whose partial product lies wholly outside the window
    (``matrix_inversion_tpu/ops/packed.py:779-798``)."""
    consts = []
    for i in range(a_len):
        indb = newints - a_ints + i + 1 - b_ints
        ind1 = 0 if indb >= 0 else -indb
        ind2 = min(b_len, newlength - indb)
        if ind2 <= ind1:
            consts.append((0, 0, 0, 0))
            continue
        consts.append((
            bits * (a_len - 1 - i),
            bits * (b_len - ind2),
            (1 << (bits * (ind2 - ind1))) - 1,
            bits * (newlength - indb - ind2),
        ))
    return consts


def mul_window_sum(a_mag, b_mag, consts, bits):
    """The raw windowed sum: one cropped partial product per row of
    ``consts`` (:func:`mul_window_consts`), summed mod 2**64, unmasked.

    int64 stands in for uint64: ``window << out_shift`` stays below 2**62
    (each cropped partial product fits the output window), the product by
    the digit and the sum wrap mod 2**64, and the sum is never shifted.
    """
    base_mask = (1 << bits) - 1
    acc = torch.zeros_like(a_mag + b_mag)
    for a_sh, b_sh, b_mask, o_sh in consts:
        if b_mask == 0:
            continue
        a_i = (a_mag >> a_sh) & base_mask
        window = ((b_mag >> b_sh) & b_mask) << o_sh
        acc = acc + (window & -a_i if bits == 1 else window * a_i)
    return acc


def mul_window_packed(a_mag, a_len, a_ints, b_mag, b_len, b_ints,
                      newlength, newints, bits):
    """The windowed multiply: one cropped partial product per digit of
    ``a``, summed mod 2**64 (``matrix_inversion_tpu/ops/packed.py:868-969``).
    Returns ``(mag, flag)``; ``mag`` at base 2 is the plain version of the
    kernel K4.

    Its magnitudes equal :func:`mul_trunc_packed`'s.  Its flag is the carry
    out of the output window, ``(acc & ~out_mask) != 0`` on the wrapped
    sum: carries past 2**64 are lost, as in the reference.
    """
    out_mask = (1 << (bits * newlength)) - 1
    acc = mul_window_sum(
        a_mag, b_mag,
        mul_window_consts(a_len, a_ints, b_len, b_ints, newlength, newints, bits),
        bits,
    )
    return acc & out_mask, (acc & ~out_mask) != 0
