"""Emit the fused kernel's body as straight-line C++ from the circuit.

The JAX package builds its Pallas kernel body by running the trace-time
circuit ``models/qfloat_lu.py`` on uint32-pair cells
(``matrix_inversion_tpu/ops/fused_inverse.py:81-149``).  The port makes
the same move for CUDA: it runs its own ``models/qfloat_lu.py`` on
:class:`EmitQFloat` cells, which record one call to a primitive of
``csrc/qfloat_cell.cuh`` per QFloat op, with the static formats
(digit bits, len, ints) as template arguments.  The op sequence, the
Zero/SignedBinary pruning and every intermediate format of the kernel
therefore equal those of the eager PyTorch path by construction.

Signs and pivot integers are :class:`Sym` values (C++ ``int`` variables);
signs that are Python ints stay constants in the emitted code.  This
module runs when a kernel is built, never inside a launch.

A tracking emitter (``Emitter(track=True)``) applies the rule of a live
``track_overflow()`` scope in ``ops/packed.py``: every op that records a
flag there emits the tracked primitive (``sadd_t``, ``mul_window_t``,
``divide_t``, ``invert_t``) and ``ovf |= flag;`` right after it.

Beside the statements the emitter keeps a tally of what it recorded, by
primitive of ``csrc/qfloat_cell.cuh`` (``Emitter.ops``): the histogram of
the kernel body that ``utils/roofline.py`` costs; and the distinct first
and second operands of its multiplies (``Emitter.mul_operands``), because
the part of a multiply that depends on one operand only is computed once
for all the multiplies that share it.  EmitQFloat cells also
bump the ``QFloatBase`` op counters where the JAX package's kernel cell
does (``matrix_inversion_tpu/ops/pair_qfloat.py:342,384,410,466,486``).
"""

from __future__ import annotations

import collections

from ..core.qfloat import QFloatBase, SignedBinary, Zero, check_invert_sign
from ..models.qfloat_lu import qfloat_matrix_inverse_cells
from .packed import digit_bits


class Emitter:
    """Collects the body's statements and hands out fresh names;
    ``track=True`` emits the tracked primitives.  ``ops`` counts the
    recorded statements by primitive: the name of the ``qfloat_cell.cuh``
    function called, ``"int"`` for a statement of :class:`Sym` arithmetic
    and ``"flag_or"`` for an ``ovf |= flag;``.  ``mul_operands`` holds the
    names of the multiplies' first operands and of their second ones (every
    name is assigned once, so a name is a value)."""

    def __init__(self, track=False):
        self.lines = []
        self.ops = collections.Counter()
        self.mul_operands = (set(), set())
        self._count = 0
        self.track = bool(track)

    def fresh(self, prefix):
        self._count += 1
        return f"{prefix}{self._count}"

    def _statement(self, prefix, type_, expr, prim):
        name = self.fresh(prefix)
        self.lines.append(f"const {type_} {name} = {expr};")
        self.ops[prim] += 1
        return name

    def int_(self, expr, prim="int"):
        return Sym(self, self._statement("t", "int", expr, prim))

    def mag(self, expr, prim):
        return self._statement("m", "uint64_t", expr, prim)

    def cell(self, expr, prim):
        return self._statement("c", "Cell", expr, prim)

    def tracked(self, type_, expr, prim):
        """A tracked primitive's result (``MagF`` or ``CellF``); its flag
        goes into ``ovf``."""
        name = self._statement("f", type_, expr, prim)
        self.lines.append(f"ovf |= {name}.f;")
        self.ops["flag_or"] += 1
        return name


def _expr(x):
    """C++ expression of a Python int or a :class:`Sym`."""
    if isinstance(x, Sym):
        return x.name
    if isinstance(x, bool) or not isinstance(x, int):
        raise TypeError(f"cannot emit {type(x).__name__} as an int")
    return str(x) if x >= 0 else f"({x})"


class Sym:
    """A C++ ``int`` of the kernel body; arithmetic emits new statements."""

    def __init__(self, em, name):
        self._em = em
        self.name = name

    def _op(self, a, op, b):
        return self._em.int_(f"{_expr(a)} {op} {_expr(b)}")

    # the operators the circuit applies to signs and pivot integers
    def __add__(self, o):
        return self._op(self, "+", o)

    def __rsub__(self, o):
        return self._op(o, "-", self)

    def __mul__(self, o):
        return self._op(self, "*", o)

    def __rmul__(self, o):
        return self._op(o, "*", self)

    def __eq__(self, o):
        return self._op(self, "==", o)

    __hash__ = None


class EmitQFloat(QFloatBase):
    """A QFloat cell of the kernel body: a magnitude variable and a sign."""

    def __init__(self, em, mag, length, ints, base, sign):
        self._em = em
        self._mag = mag
        self._length = int(length)
        self._ints = int(ints)
        self._base = int(base)
        self._bits = digit_bits(self._base)
        if not (0 <= self._ints <= self._length):
            raise ValueError("ints must be in range [0, length]")
        if self._bits * self._length > 62:
            raise ValueError("encoding too wide for the packed backend")
        self._sign = sign

    def __len__(self):
        return self._length

    @property
    def mag(self):
        return self._mag

    def _fmt(self):
        return f"{self._bits}, {self._length}, {self._ints}"

    def _mask(self, ndigits=None):
        n = self._length if ndigits is None else ndigits
        return (1 << (self._bits * n)) - 1

    def copy(self):
        return EmitQFloat(self._em, self._mag, self._length, self._ints,
                          self._base, self._sign)

    def set_len_ints(self, newlen, newints):
        self._mag = self._em.mag(
            f"set_len_ints<{self._fmt()}, {int(newlen)}, {int(newints)}>({self._mag})",
            "set_len_ints",
        )
        self._length, self._ints = int(newlen), int(newints)
        return self

    def __gt__(self, other):
        self.check_compatibility(other)
        return self._em.int_(
            f"gt({self._mag}, {_expr(self._sign)}, {other._mag}, {_expr(other._sign)})",
            "gt",
        )

    def __iadd__(self, other):
        if isinstance(other, Zero):
            return self
        QFloatBase.ADDITIONS += 1
        if isinstance(other, SignedBinary):
            unit = 1 << (self._bits * (self._length - self._ints))
            omag, osign = f"{unit}ull", other.value
        elif isinstance(other, EmitQFloat):
            self.check_compatibility(other)
            omag, osign = other._mag, other._sign
        else:
            raise TypeError(f"cannot add {type(other).__name__} to an EmitQFloat")
        args = (
            f"<{self._bits}, {self._length}>({self._mag}, {_expr(self._sign)}, "
            f"{omag}, {_expr(osign)})"
        )
        if not self._em.track:
            c = self._em.cell(f"sadd{args}", "sadd")
        else:
            c = self._em.tracked("CellF", f"sadd_t{args}", "sadd_t")
        self._mag, self._sign = f"{c}.m", Sym(self._em, f"{c}.s")
        return self

    def __imul__(self, other):
        if isinstance(other, SignedBinary):
            self._sign = self._sign * other.value
            return self
        if not isinstance(other, EmitQFloat):
            raise TypeError(f"cannot multiply an EmitQFloat by {type(other).__name__}")
        QFloatBase.MULTIPLICATION += 1
        self.check_compatibility(other)
        self._mag = _mul_mag(self, other, self._length, self._ints)
        self._sign = self._sign * other._sign
        return self

    @classmethod
    def from_mul(cls, a, b, newlength=None, newints=None):
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
        mag = _mul_mag(a, b, newlength, newints)
        return cls(a._em, mag, newlength, newints, a.base, a.sign * b.sign)

    def __itruediv__(self, other):
        if isinstance(other, Zero):
            raise ValueError("division by Zero")
        if isinstance(other, SignedBinary):
            v = other.value
            if isinstance(v, int):
                if v == 0:
                    self._mag = f"{self._mask()}ull"
                else:
                    self._sign = v
                return self
            self._mag = self._em.mag(
                f"sb_div_mag<{self._bits}, {self._length}>({self._mag}, {_expr(v)})",
                "sb_div_mag",
            )
            self._sign = self._em.int_(
                f"sb_div_sign({_expr(self._sign)}, {_expr(v)})", "sb_div_sign"
            )
            return self
        QFloatBase.DIVISION += 1
        self.check_compatibility(other)
        args = f"<{self._fmt()}>({self._mag}, {other._mag})"
        if not self._em.track:
            self._mag = self._em.mag(f"divide{args}", "divide")
        else:
            self._mag = f"{self._em.tracked('MagF', f'divide_t{args}', 'divide_t')}.m"
        self._sign = self.sign * other.sign
        return self

    def invert(self, sign=1, newlength=None, newints=None):
        check_invert_sign(sign)
        QFloatBase.DIVISION += 1
        if newlength is None:
            newlength = self._length
        if newints is None:
            newints = self._ints
        args = f"<{self._fmt()}, {int(newlength)}, {int(newints)}>({self._mag})"
        n_digits = 1 + (self._length - self._ints) + (newlength - newints)
        if not self._em.track or newlength >= n_digits:
            # an uncropped quotient records nothing (ops/packed.py invert)
            mag = self._em.mag(f"invert{args}", "invert")
        else:
            mag = f"{self._em.tracked('MagF', f'invert_t{args}', 'invert_t')}.m"
        sb = sign.value if isinstance(sign, SignedBinary) else sign
        return EmitQFloat(self._em, mag, newlength, newints, self._base, sb * self.sign)

    def blend_from(self, other, cond):
        self._mag = self._em.mag(
            f"blend({_expr(cond)}, {other._mag}, {self._mag})", "blend"
        )
        return self


def _mul_mag(a, b, newlength, newints):
    """Magnitude of the product of two EmitQFloat cells at a new format:
    the truncated ``mul``, or under tracking the windowed ``mul_window_t``
    (the rule of ``ops/packed.py::_mul_packed``)."""
    args = (
        f"<{a._fmt()}, {b._length}, {b._ints}, {int(newlength)}, {int(newints)}>"
        f"({a._mag}, {b._mag})"
    )
    a._em.mul_operands[0].add(a._mag)
    a._em.mul_operands[1].add(b._mag)
    if not a._em.track:
        return a._em.mag(f"mul{args}", "mul")
    return f"{a._em.tracked('MagF', f'mul_window_t{args}', 'mul_window_t')}.m"


def emit_circuit(n, qfloat_len, qfloat_ints, qfloat_base, true_division, track=False):
    """Run the inversion circuit of one configuration on :class:`EmitQFloat`
    cells; returns the :class:`Emitter` holding the body's statements
    (stores of the outputs included) and its tally ``ops``."""
    em = Emitter(track)
    M = [
        [
            EmitQFloat(em, f"m[{i * n + j}]", qfloat_len, qfloat_ints, qfloat_base,
                       Sym(em, f"s[{i * n + j}]"))
            for j in range(n)
        ]
        for i in range(n)
    ]
    Minv = qfloat_matrix_inverse_cells(M, qfloat_len, qfloat_ints, true_division)
    for i in range(n):
        for j in range(n):
            cell = Minv[i][j]
            if not isinstance(cell, EmitQFloat):
                raise TypeError(f"output cell is a {type(cell).__name__}")
            em.lines.append(f"om[{i * n + j}] = {cell.mag};")
            em.lines.append(f"os[{i * n + j}] = {_expr(cell.sign)};")
    return em


def emit_body(n, qfloat_len, qfloat_ints, qfloat_base, true_division, track=False):
    """C++ source of ``fused_body`` for one configuration.

    The source defines ``FUSED_N2`` and, inside namespace ``qcell``,
    ``fused_body(m, s, om, os)``: the inverse of one matrix from its
    ``n*n`` cell magnitudes ``m`` and signs ``s`` (row-major) into
    ``om``/``os``.  ``track=True`` also defines ``FUSED_TRACK`` as 1, and
    ``fused_body`` then returns the matrix's overflow flag.
    """
    em = emit_circuit(n, qfloat_len, qfloat_ints, qfloat_base, true_division, track)
    header = (
        "// Emitted by matrix_inversion_tpu_torch/ops/emit.py from "
        "models/qfloat_lu.py: do not edit.\n"
        f"// n={n} len={qfloat_len} ints={qfloat_ints} base={qfloat_base} "
        f"true_division={int(bool(true_division))}"
        + (" track=1\n#define FUSED_TRACK 1\n" if track else "\n")
        + f"#define FUSED_N2 {n * n}\n"
        "namespace qcell {\n"
        f"QI_FN {'int' if track else 'void'} fused_body(const uint64_t* m, "
        "const int* s, uint64_t* om, int* os) {\n"
    )
    if track:
        em.lines.insert(0, "int ovf = 0;")
        em.lines.append("return ovf;")
    return header + "".join(f"  {line}\n" for line in em.lines) + "}\n}  // namespace qcell\n"
