"""Batched base-p digit arrays: the limb backend's arithmetic, any base.

Port of ``matrix_inversion_tpu/ops/limbs.py:29-286`` on int32 torch
tensors, with the same semantics, the reference's quirks and the conscious
base>2 borrow fix included.  Digits are most significant first on the last
axis (digit j of an n-digit array has place value ``p**(n-1-j)``); every
function broadcasts over the leading batch axes, so the reference's
``multi_*`` variants are aliases.  JAX runs the carry and borrow chains as
``lax.scan`` over the digit axis; here :func:`_scan_digits` is a Python
loop over it, one set of eager ops a digit.

Three chains run in hand-written kernels on CUDA tensors
(``ops/limb_kernels.py``, which takes nothing else): the long division
:func:`base_p_division` in K6, :func:`base_tidy` and
:func:`tidy_to_sign_mag` (a tidy and the sign in one launch) in K7.  A CPU
tensor, or any tensor inside ``ops.packed.plain_arithmetic()``, takes their
plain versions (the ``*_reference`` functions), which give the same bits;
this module alone makes that choice.
"""

from __future__ import annotations

import torch

DIGIT_DTYPE = torch.int32


def _to_kernel(t):
    """Whether a chain on ``t`` launches a kernel (``ops.packed._to_kernel``:
    a CUDA tensor outside ``plain_arithmetic()``)."""
    from . import packed  # packed imports core.qfloat, which imports this module

    return packed._to_kernel(t)


def _bcast_batch(a, b):
    """Broadcast the batch (all-but-last) dims of two digit arrays."""
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return a.expand(batch + a.shape[-1:]), b.expand(batch + b.shape[-1:])


def _scan_digits(step, init, digits):
    """Run ``step(carry, digit)`` over the digit axis from least to most
    significant.  ``digits``: [..., L].  Returns ``(final_carry, ys)`` with
    ys in digit order ([..., L])."""
    carry = init
    ys = [None] * digits.shape[-1]
    for j in range(digits.shape[-1] - 1, -1, -1):
        carry, ys[j] = step(carry, digits[..., j])
    return carry, torch.stack(ys, dim=-1)


def _borrow_step(p):
    """One digit of a borrow chain: ``(borrow, d) -> (borrow', d - borrow
    + p * borrow')``."""

    def step(borrow, d):
        temp = d - borrow
        new_borrow = (temp < 0).to(d.dtype)
        return new_borrow, temp + p * new_borrow

    return step


def _compare_step(borrow, d):
    new_borrow = (d - borrow < 0).to(d.dtype)
    return new_borrow, new_borrow


def base_p_addition(a, b, p: int):
    """Ripple-carry addition of positive tidy digit arrays: only the trailing
    ``min(a, b)`` digits are computed; any extra leading digits of the result
    stay zero (the final carry is dropped)."""
    a, b = _bcast_batch(a, b)
    min_size = min(a.shape[-1], b.shape[-1])
    s = a[..., -min_size:] + b[..., -min_size:]

    def step(carry, d):
        tot = d + carry
        return tot // p, tot % p

    _, tail = _scan_digits(step, s.new_zeros(s.shape[:-1]), s)
    result = a.new_zeros(a.shape)
    result[..., -min_size:] = tail
    return result


def base_p_subtraction(a, b, p: int, overflow: bool = False):
    """Borrow-chain subtraction of tidy digit arrays with the reference's
    different-length semantics; ``overflow=True`` also returns the ``a < b``
    flag from the final borrow and the extra leading digits."""
    a, b = _bcast_batch(a, b)
    wa, wb = a.shape[-1], b.shape[-1]
    min_size = min(wa, wb)
    a_minus_b = a[..., -min_size:] - b[..., -min_size:]
    borrow, tail = _scan_digits(_borrow_step(p), a_minus_b.new_zeros(a_minus_b.shape[:-1]),
                                a_minus_b)
    difference = a.new_zeros(a.shape)
    difference[..., -min_size:] = tail
    if not overflow:
        return difference
    diff = wb - wa
    if diff == 0:
        a_lt_b = borrow
    elif diff < 0:
        a_lt_b = borrow * (a[..., 0:-diff].sum(-1) == 0).to(borrow.dtype)
        difference[..., 0:-diff] = a[..., 0:-diff]
    else:
        has_high = (b[..., 0:diff].sum(-1) > 0).to(borrow.dtype)
        a_lt_b = torch.maximum(borrow, has_high)
    return difference, a_lt_b


def is_greater_or_equal(a, b):
    """Whether tidy ``a >= b`` by the borrow chain of ``a - b`` over the
    trailing ``min`` digits only."""
    a, b = _bcast_batch(a, b)
    min_size = min(a.shape[-1], b.shape[-1])
    a_minus_b = a[..., -min_size:] - b[..., -min_size:]
    borrow, _ = _scan_digits(_compare_step, a_minus_b.new_zeros(a_minus_b.shape[:-1]),
                             a_minus_b)
    return 1 - borrow


def is_greater_or_equal_base_p(a, b):
    """Length-aware ``a >= b``."""
    a, b = _bcast_batch(a, b)
    diff = b.shape[-1] - a.shape[-1]
    if diff == 0:
        return is_greater_or_equal(a, b)
    if diff > 0:
        return is_greater_or_equal(a, b[..., diff:]) * (
            b[..., 0:diff].sum(-1) == 0
        ).to(DIGIT_DTYPE)
    ge = is_greater_or_equal(a[..., -diff:], b)
    return torch.maximum(ge, (a[..., 0:-diff].sum(-1) > 0).to(ge.dtype))


def is_equal(a, b):
    """Digit-by-digit equality, int32 0/1."""
    a, b = _bcast_batch(a, b)
    n = a.shape[-1]
    return ((n - (a == b).to(DIGIT_DTYPE).sum(-1)) == 0).to(DIGIT_DTYPE)


def is_positive(a):
    """1 where a base-tidy signed digit array is >= 0, by its borrow chain."""
    borrow, _ = _scan_digits(_compare_step, a.new_zeros(a.shape[:-1]), a)
    return 1 - borrow


def _subtract_full_width(a, b, p: int):
    """Exact ``(difference, a_lt_b)`` with the borrow carried through all of
    ``a``'s digits (``b`` zero-padded on the left): the JAX package's
    conscious fix of the reference's borrow for bases above 2 (its
    ``ops/limbs.py:162-192``).  For base 2 digit-identical to the reference;
    for any base the true difference mod ``p**len(a)``."""
    a, b = _bcast_batch(a, b)
    wa, wb = a.shape[-1], b.shape[-1]
    if wb < wa:
        b = torch.cat([b.new_zeros(b.shape[:-1] + (wa - wb,)), b], dim=-1)
    a_minus_b = a - b[..., -wa:]
    borrow, difference = _scan_digits(
        _borrow_step(p), a_minus_b.new_zeros(a_minus_b.shape[:-1]), a_minus_b)
    if wb > wa:
        has_high = (b[..., 0:wb - wa].sum(-1) > 0).to(borrow.dtype)
        borrow = torch.maximum(borrow, has_high)
    return difference, borrow


def base_p_division(dividend, divisor, p: int):
    """Restoring long division of positive tidy digit arrays: the
    ``dividend``'s length of quotient digits, all ``p-1`` where the divisor
    is zero.  K6 on a CUDA tensor (``ops/limb_kernels.py``), else
    :func:`base_p_division_reference`."""
    if _to_kernel(divisor):
        from . import limb_kernels

        return limb_kernels.limb_division(dividend, divisor, p)
    return base_p_division_reference(dividend, divisor, p)


def base_p_division_reference(dividend, divisor, p: int):
    """The plain version of K6, the JAX package's loop step for step: per
    quotient digit ``p-1`` rounds of branchless subtract, compare and
    select; the remainder window grows to ``divisor_len + 1`` digits, then
    drops its leading digit as the next comes in."""
    dividend, divisor = _bcast_batch(dividend, divisor)
    d_len = dividend.shape[-1]
    v_len = divisor.shape[-1]
    quotient_digits = []
    remainder = dividend[..., 0:1]
    for i in range(d_len):
        if i > 0:
            drop = 1 * (remainder.shape[-1] > v_len)
            remainder = torch.cat([remainder[..., drop:], dividend[..., i:i + 1]], dim=-1)
        qdigit = dividend.new_zeros(dividend.shape[:-1])
        for _ in range(p - 1):
            difference, is_lt = _subtract_full_width(remainder, divisor, p)
            is_ge = 1 - is_lt
            remainder = difference * is_ge[..., None] + remainder * is_lt[..., None]
            qdigit = qdigit + is_ge
        quotient_digits.append(qdigit)
    return torch.stack(quotient_digits, dim=-1)


def base_tidy(arr, base: int):
    """Propagate signed carries so that digits land in ]-base, base[; the
    carry past the most significant digit is dropped.  K7 on a CUDA tensor,
    else :func:`base_tidy_reference`."""
    if _to_kernel(arr):
        from . import limb_kernels

        return limb_kernels.limb_tidy(arr, base)
    return base_tidy_reference(arr, base)


def base_tidy_reference(arr, base: int):
    """The plain version of K7's tidy mode: the carry chain as a scan."""

    def step(carry, d):
        curr = d + carry
        dividend = torch.sign(curr) * (curr.abs() // base)
        return dividend, curr - dividend * base

    _, tidied = _scan_digits(step, arr.new_zeros(arr.shape[:-1]), arr)
    return tidied


def tidy_to_sign_mag(arr, base: int):
    """Resolve a mixed-sign digit array to ``(|digits|, sign)``, sign +1
    where the value is >= 0, after :func:`base_tidy` (which leaves a tidy
    array as it is): ``base_tidy`` then the sign, as ``QFloat.__iadd__``
    runs them.  One K7 launch on a CUDA tensor, else the two plain
    versions."""
    if _to_kernel(arr):
        from . import limb_kernels

        return limb_kernels.limb_tidy(arr, base, signed=True)
    return tidy_to_sign_mag_reference(base_tidy_reference(arr, base), base)


def tidy_to_sign_mag_reference(arr, base: int):
    """The plain version of K7's sign mode on a tidy array: split the
    positive and negative parts, subtract both ways, select by the borrow."""
    pos = arr * (arr >= 0)
    abs_neg = -(arr * (arr < 0))
    p_minus_n, is_negative = base_p_subtraction(pos, abs_neg, base, True)
    is_pos_or_0 = 1 - is_negative
    mag = (
        is_pos_or_0[..., None] * p_minus_n
        + is_negative[..., None] * base_p_subtraction(abs_neg, pos, base)
    )
    sign = 2 * is_pos_or_0 - 1
    return mag, sign


def tensor_fast_boolean_mul(x, boolean):
    """The reference's packed boolean multiply (base_p_arrays.py:359-365):
    ``x`` and a 0/1 flag packed into one value, selected on the flag bit."""
    pack = (x * 2) + boolean
    return torch.where(pack & 1 == 0, torch.zeros_like(pack), pack >> 1)


# The reference's tensorized variants work on a stacked leading axis; every
# function above broadcasts over leading axes already.
multi_base_p_subtraction = base_p_subtraction
multi_base_p_division = base_p_division
multi_is_greater_or_equal = is_greater_or_equal
multi_is_greater_or_equal_base_p = is_greater_or_equal_base_p
multi_base_tidy = base_tidy
