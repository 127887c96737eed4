"""Plain PyTorch reference of the QFloat matrix inverse on packed cells.

The circuit of the reference implementation (zama-ai/bounty-matrix-inversion,
``qfloat_matrix_inversion.py``: pivot, Doolittle LU, forward and backward
substitution, the 2x2 closed form) on cells that hold a QFloat of a
power-of-two base as one int64 magnitude and a sign in {-1, 0, +1}.  Every
operation is a handful of eager ``torch`` integer ops, so it runs on the CPU
or on a card as it is, and gives the bits of the reference's digit loops:

* a sum is taken on the signed integers and tidied: the magnitude is kept
  mod ``base**len`` and the sign of zero is +1;
* a product of two QFloats is the reference's cropped sum of partial
  products, the digits of ``a`` at or above the crop in one wide multiply
  and each digit below it with its own floor, all mod 2**64 as its uint64
  sums, then masked to the output width;
* a division is one exact floor division of ``mag << frac`` by the divisor,
  a zero divisor saturating every quotient digit, as the restoring loop;
* ``Zero`` and ``SignedBinary`` cells (``Bin`` here) are the reference's
  build-time types: a zero that prunes its operations, a value in {-1, 0, 1}
  (the pivot permutation, the diagonal of L) that only moves signs.

Tracked (``inverse(..., track=True)``), every operation that drops digits
past the top of its window records a per-matrix flag, and a matrix's flag is
the OR of them all: a sum's carry past the top digit on tidy, a quotient or
an inverse with digits past its top, and a product whose windowed sum
carries out of the window (:func:`mul_window`, with its quirks).  The
magnitudes and signs are those of the untracked circuit.

The argmax of the pivot blends the magnitude of its running maximum and not
its sign, as the reference's ``qfloat_argmax`` does.
"""

from __future__ import annotations

import torch


class Zero:
    """A cell known to be zero while the circuit is built."""


class Bin:
    """A cell known to hold a value in {-1, 0, 1}: an int or an int tensor."""

    def __init__(self, value):
        self.value = value


class Cell:
    """A QFloat of base ``2**bits``: ``length`` digits, ``ints`` of them
    before the dot, magnitude ``mag`` (int64 tensor), sign ``sign`` (an int
    or an int64 tensor in {-1, 0, 1}; 0 makes the value act as zero).
    ``flags`` is the list of overflow flags of the inversion the cell is part
    of, shared by all its cells, or None where it is not tracked."""

    def __init__(self, mag, sign, length, ints, bits, flags=None):
        self.mag, self.sign = mag, sign
        self.length, self.ints, self.bits = length, ints, bits
        self.flags = flags

    def like(self, mag, sign):
        return Cell(mag, sign, self.length, self.ints, self.bits, self.flags)

    def mask(self, digits=None):
        return (1 << (self.bits * (self.length if digits is None else digits))) - 1

    def unit(self):
        """The magnitude of 1 in this format."""
        return 1 << (self.bits * (self.length - self.ints))


def _as_tensor(sign, like):
    return sign if isinstance(sign, torch.Tensor) else torch.full_like(like, int(sign))


def _tidy(cell, v):
    """A cell of ``cell``'s format holding the signed integer ``v``; a carry
    past the top digit is dropped, and recorded."""
    mag = v.abs() & cell.mask()
    if cell.flags is not None:
        cell.flags.append(v.abs() > cell.mask())
    return cell.like(mag, torch.where((v < 0) & (mag != 0), -1, 1))


def _signed(cell, other):
    """The signed integer of ``other`` in ``cell``'s format."""
    if isinstance(other, Bin):
        return cell.unit() * other.value
    return other.mag * other.sign


def add(a, b):
    """``a + b``, in the format of the QFloat operand."""
    if isinstance(b, Zero):
        return a
    if isinstance(a, Zero):
        return b
    if isinstance(a, Bin):
        a, b = b, a
    if isinstance(a, Bin):
        return a.value + b.value
    return _tidy(a, _signed(a, a) + _signed(a, b))


def neg(a):
    if isinstance(a, Zero):
        return a
    if isinstance(a, Bin):
        return Bin(-1 * a.value)
    return a.like(a.mag, a.sign * -1)


def sub(a, b):
    """``a - b``."""
    return add(neg(b), a)


def cell_abs(a):
    return a.like(a.mag, a.sign * a.sign)


def mul_trunc(a_mag, a_len, a_ints, b_mag, b_len, b_ints, newlength, newints, bits):
    """The reference's cropped partial-product sum (its qfloat.py:995-1016)
    as int64 arithmetic: digits of ``a`` at or above the crop share one
    multiply, each digit below it keeps its own floor of ``b``; the sums wrap
    mod 2**64 as its uint64 ones, and the mask keeps the output window."""
    out_mask = (1 << (bits * newlength)) - 1
    t_dig = (a_len - a_ints) + (b_len - b_ints) - (newlength - newints)
    t1 = bits * t_dig
    if t1 <= 0:
        return ((a_mag * b_mag) << (-t1)) & out_mask
    acc = (a_mag >> t1) * b_mag
    digit = (1 << bits) - 1
    for p in range(max(0, t_dig - b_len + 1), min(t_dig, a_len)):
        acc = acc + (b_mag >> (bits * (t_dig - p))) * ((a_mag >> (bits * p)) & digit)
    return acc & out_mask


def mul_window(a_mag, a_len, a_ints, b_mag, b_len, b_ints, newlength, newints, bits):
    """The product as the tracked circuit forms it, to see its overflow:
    ``(magnitude, carry)``.  For each digit of ``a`` (from the top, index
    ``i``, place ``bits * (a_len - 1 - i)``), digit ``k`` of ``b`` lands on
    digit ``i + k + newints - a_ints - b_ints + 1`` of the output (from its
    top); the digits of ``b`` that land on ``0 .. newlength - 1`` are
    multiplied by the digit of ``a``, put in their place and summed.  The
    magnitude is the sum's low ``newlength`` digits, the same as
    :func:`mul_trunc`'s; ``carry`` is whether the sum has a bit above them.

    Two quirks of that flag, kept as the circuit has them:

    * the sum wraps mod 2**64 (int64 here, as uint64 there), so a carry
      that reaches 2**64 and leaves no bit below it goes unseen;
    * digits of ``b`` that land above the output's top digit are left out
      before the sum, so what they would add is dropped and never flagged.
    """
    out_mask = (1 << (bits * newlength)) - 1
    digit = (1 << bits) - 1
    acc = torch.zeros_like(a_mag + b_mag)
    for i in range(a_len):
        top = newints - a_ints - b_ints + 1 + i  # the output digit of b's digit 0
        first, end = max(0, -top), min(b_len, newlength - top)
        if end <= first:
            continue
        window = (b_mag >> (bits * (b_len - end))) & ((1 << (bits * (end - first))) - 1)
        a_i = (a_mag >> (bits * (a_len - 1 - i))) & digit
        acc = acc + (window << (bits * (newlength - top - end))) * a_i
    return acc & out_mask, (acc & ~out_mask) != 0


def mul(a, b, newlength=None, newints=None):
    """``a * b``; two QFloats give the windowed product in ``a``'s format,
    or in ``(newlength, newints)``."""
    if isinstance(a, Zero) or isinstance(b, Zero):
        return Zero()
    if isinstance(a, Bin) and isinstance(b, Bin):
        return Bin(a.value * b.value)
    if isinstance(a, Bin) or isinstance(b, Bin):
        cell, factor = (b, a) if isinstance(a, Bin) else (a, b)
        if newlength is not None:
            raise ValueError("a signed binary product keeps its cell's format")
        return cell.like(cell.mag, cell.sign * factor.value)
    length = a.length if newlength is None else newlength
    ints = a.ints if newints is None else newints
    operands = (a.mag, a.length, a.ints, b.mag, b.length, b.ints, length, ints, a.bits)
    if a.flags is None:
        mag = mul_trunc(*operands)
    else:
        mag, carry = mul_window(*operands)
        a.flags.append(carry)
    return Cell(mag, a.sign * b.sign, length, ints, a.bits, a.flags)


def floor_div(dividend, divisor, n_bits):
    """``dividend // divisor``; a zero divisor gives ``n_bits`` ones."""
    is_zero = divisor == 0
    q = torch.div(dividend, torch.where(is_zero, 1, divisor), rounding_mode="floor")
    return torch.where(is_zero, (1 << n_bits) - 1, q)


def div(a, b):
    """True division of two QFloats of one format; quotient digits past the
    top are dropped, and recorded (a zero divisor's saturated quotient has
    them)."""
    frac = a.length - a.ints
    n_bits = a.bits * (a.length + frac)
    q = floor_div(a.mag << (a.bits * frac), b.mag, n_bits)
    if a.flags is not None:
        a.flags.append((q >> (a.bits * a.length)) != 0)
    return a.like(q & a.mask(), a.sign * b.sign)


def invert(a, sign, newlength, newints):
    """``sign / a`` in the format ``(newlength, newints)``; digits past its
    top are dropped, and recorded, where the format is narrower than the
    quotient."""
    frac, frac_self = newlength - newints, a.length - a.ints
    n_digits = 1 + frac_self + frac
    dividend = torch.full_like(a.mag, 1 << (a.bits * (frac_self + frac)))
    q = floor_div(dividend, a.mag, a.bits * n_digits)
    if newlength < n_digits:
        if a.flags is not None:
            a.flags.append((q >> (a.bits * newlength)) != 0)
        q = q & ((1 << (a.bits * newlength)) - 1)
    return Cell(q, sign * a.sign, newlength, newints, a.bits, a.flags)


def greater(a, b):
    """``a > b`` as a 0/1 int64 tensor, compared in the select form of the
    reference (its qfloat.py:711-739)."""
    sa, sb = _as_tensor(a.sign, a.mag), _as_tensor(b.sign, b.mag)
    flip = (sa < 0) & (a.mag != b.mag)
    return torch.where(sa == sb, (a.mag > b.mag) ^ flip, sa > sb).to(torch.int64)


def dot(xs, ys):
    """``sum_k xs[k] * ys[k]``, accumulated from the first term."""
    acc = mul(xs[0], ys[0])
    for x, y in zip(xs[1:], ys[1:]):
        acc = add(acc, mul(x, y))
    return acc


def argmax(cells):
    """Index (from 0) of the largest cell by a branchless scan that blends
    only the magnitude of the running maximum."""
    best = cells[0]
    index = 0
    for i in range(1, len(cells)):
        gt = greater(cells[i], best)
        best = best.like(torch.where(gt != 0, cells[i].mag, best.mag), best.sign)
        index = gt * i + (1 - gt) * index
    return index


def pivot(M):
    """The permutation P (PM = LU) as an n x n list of 0/1 ints or tensors:
    for each column j, row j swaps with the row of the largest |M[i][j]|,
    i >= j, of the original matrix."""
    n = len(M)
    P = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for j in range(n - 1):
        r = j + argmax([cell_abs(M[i][j]) for i in range(j, n)])
        old = [row[:] for row in P]
        for c in range(n):
            P[j][c] = sum(old[i][c] * ((r == i) * 1) for i in range(j, n))
        for i in range(j + 1, n):
            e = (r == i) * 1
            for c in range(n):
                P[i][c] = (1 - e) * old[i][c] + e * old[j][c]
    return [[Bin(v) for v in row] for row in P]


def lu(P, M, length, ints, true_division):
    """Doolittle LU of PM; returns (L, U)."""
    n = len(M)
    PM = [[dot(P[i], [M[k][j] for k in range(n)]) for j in range(n)] for i in range(n)]
    L = [[Zero() for _ in range(n)] for _ in range(n)]
    U = [[Zero() for _ in range(n)] for _ in range(n)]
    for j in range(n):
        L[j][j] = Bin(1)
        for i in range(j + 1):
            if i == 0:
                U[i][j] = PM[i][j]
            else:
                s = dot([U[k][j] for k in range(i)], [L[i][k] for k in range(i)])
                U[i][j] = add(PM[i][j], neg(s))
        if not true_division:
            inv_ujj = invert(U[j][j], 1, length, 0)
        for i in range(j + 1, n):
            num = PM[i][j]
            if j > 0:
                s = dot([U[k][j] for k in range(j)], [L[i][k] for k in range(j)])
                num = add(num, neg(s))
            L[i][j] = div(num, U[j][j]) if true_division else mul(num, inv_ujj, length, ints)
    return L, U


def lu_inverse(P, L, U, length, ints, true_division):
    """The inverse from PM = LU: L Y = P^T, then U X = Y; returns X^T."""
    n = len(L)
    Pt = [[P[j][i] for j in range(n)] for i in range(n)]
    Y = [[Zero() for _ in range(n)] for _ in range(n)]
    for i in range(n):
        Y[i][0] = Pt[i][0]
        for j in range(1, n):
            Y[i][j] = sub(Pt[i][j], dot([L[j][k] for k in range(j)], [Y[i][k] for k in range(j)]))
    if not true_division:
        inv_u = [invert(U[j][j], 1, length, 0) for j in range(n)]

    def solve(num, j):
        return div(num, U[j][j]) if true_division else mul(num, inv_u[j], length, ints)

    X = [[Zero() for _ in range(n)] for _ in range(n)]
    for i in range(n - 1, -1, -1):
        X[i][n - 1] = solve(Y[i][n - 1], n - 1)
        for j in range(n - 2, -1, -1):
            s = dot([U[j][k] for k in range(j + 1, n)], [X[i][k] for k in range(j + 1, n)])
            X[i][j] = solve(sub(Y[i][j], s), j)
    return [[X[j][i] for j in range(n)] for i in range(n)]


def inverse_2x2(M, length, ints):
    """adj(M) / det(M), the products widened to ``2 * ints + 3`` digits."""
    (a, b), (c, d) = M
    wide, wide_ints = 2 * ints + 3, 2 * ints
    det = add(mul(a, d, wide, wide_ints), neg(mul(b, c, wide, wide_ints)))
    det_inv = invert(det, 1, length, 0)
    m = lambda x: mul(x, det_inv, length, ints)  # noqa: E731
    return [[m(d), neg(m(b))], [neg(m(c)), m(a)]]


def inverse_cells(mags, signs, n, length, ints, bits, true_division, flags=None):
    """``(..., n*n)`` int64 magnitudes and signs -> the inverse's cells;
    ``flags``, a list, takes the overflow flags of every operation."""
    M = [[Cell(mags[..., i * n + j], signs[..., i * n + j], length, ints, bits, flags)
          for j in range(n)] for i in range(n)]
    if n == 2:
        return inverse_2x2(M, length, ints)
    P = pivot(M)
    L, U = lu(P, M, length, ints, true_division)
    return lu_inverse(P, L, U, length, ints, true_division)


def inverse(mags, signs, n, length, ints, bits, true_division, track=False):
    """The QFloat inverse of a batch: ``(..., n*n)`` int64 magnitudes and
    signs in, the same out; ``track`` adds a third output, the int32 flag of
    each matrix (the batch's shape): 1 where some operation overflowed."""
    flags = [] if track else None
    cells = [c for row in inverse_cells(mags, signs, n, length, ints, bits, true_division, flags)
             for c in row]
    if not all(isinstance(c, Cell) for c in cells):
        raise TypeError("every cell of an inverse is a QFloat")
    out_mags = torch.stack([torch.broadcast_to(c.mag, mags.shape[:-1]) for c in cells], -1)
    out_signs = torch.stack(
        [torch.broadcast_to(_as_tensor(c.sign, c.mag), mags.shape[:-1]) for c in cells], -1)
    out = out_mags.to(torch.int64), out_signs.to(torch.int64)
    if not track:
        return out
    overflowed = torch.zeros(mags.shape[:-1], dtype=torch.bool, device=mags.device)
    for flag in flags:
        overflowed |= flag
    return out + (overflowed.to(torch.int32),)
