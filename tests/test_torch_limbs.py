"""The limb backend's digit arithmetic (``ops/limbs.py``) and its kernels K6
and K7, on the CPU.

Every function of the port's ``ops/limbs.py`` is held with tolerance 0
against the JAX package's ``ops/limbs.py`` on the same numpy inputs, at
bases 2, 3, 10 and 16, equal and different lengths, ``overflow=True``, the
widths of every preset's multiplies (the tidies) and divisions, zero
divisors and divisors with leading zeros.  JAX compiles a scan per width,
so its long division runs at the High widths, Low's reciprocal and a
smaller width at each other base; the port runs every preset's division
widths against Python's integer floor division (the function JAX's
computes, ``tests/test_limbs.py``).

``csrc/limb_division.cu`` (K6) and ``csrc/limb_tidy.cu`` (K7) compile as
host C++ without ``__CUDACC__``: the same per-number functions, K7's staging
through its block buffer phase by phase.  Built here with g++, they are held
against the plain versions and JAX on the same cases, and against the plain
versions on any base 2-16 and lengths 1-64 that hypothesis picks.  K6 keeps
its remainder window in 64-bit words, a compile-time instance for each
count of words: it is held at every word-count boundary of bases 2, 3, 7,
10, 16 and 1,000 to Python's floor division (and to JAX's where the window
first needs two words), on the divisors and windows that test its estimate
of a digit, and in the limb inversions' own calls, whose digits are checked
to lie in ``[0, p)``, the range the word window takes.  K6 also as built
with ``-DLIMB_DIGIT_WINDOW`` (its first design, which the card times
against), and its form with the window in global scratch at a 300-digit
divisor.
"""

import ctypes
import functools
import subprocess

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_inversion_tpu.ops import limbs as jax_limbs

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.ops import limb_kernels, limbs, packed
from matrix_inversion_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(2)

BASES = (2, 3, 10, 16)


def digits(rng, shape, p):
    return rng.randint(0, p, size=shape).astype(np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def same(got, ref):
    """Port output(s) == JAX output(s), values and shapes."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            same(g, r)
        return
    r = np.asarray(ref)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == r.shape, (g.shape, r.shape)
    np.testing.assert_array_equal(g, r)


def value(d, p):
    """Python-int value of each row of a digit array, most significant first."""
    out = []
    for row in np.asarray(d).reshape(-1, d.shape[-1]).tolist():
        v = 0
        for x in row:
            v = v * p + int(x)
        out.append(v)
    return out


def floor_quotient(v, d, p):
    """The quotient digits K6 and JAX give: floor(v / d), all p-1 where d = 0."""
    d_len = v.shape[-1]
    q = np.empty(np.broadcast_shapes(v.shape[:-1], d.shape[:-1]) + (d_len,), np.int64)
    vv = value(np.broadcast_to(v, q.shape[:-1] + v.shape[-1:]), p)
    dv = value(np.broadcast_to(d, q.shape[:-1] + d.shape[-1:]), p)
    flat = q.reshape(-1, d_len)
    for i, (a, b) in enumerate(zip(vv, dv)):
        x = a // b if b else p ** d_len - 1
        for j in range(d_len - 1, -1, -1):
            flat[i, j] = x % p
            x //= p
    return q


def division_widths():
    """``(name, d_len, v_len)`` of every preset's divisions: the true
    division (``len + frac`` by ``len``), the reciprocal (``1 + frac + len``
    by ``len``) and the 2x2 closed form's (``1 + 3 + len`` by ``2*ints+3``)."""
    out = []
    for name in ("low", "medium", "high"):
        p = mt.PRESETS[name]
        out += [(f"{name}_divide", p.qfloat_len + p.frac, p.qfloat_len),
                (f"{name}_invert", 1 + p.frac + p.qfloat_len, p.qfloat_len),
                (f"{name}_invert_2x2", 4 + p.qfloat_len, 2 * p.qfloat_ints + 3)]
    return out


DIVISION_WIDTHS = division_widths()
# the tidies: every preset's multiply and add width, and the 2x2 form's
TIDY_WIDTHS = sorted({w for name in ("low", "medium", "high")
                      for w in (mt.PRESETS[name].qfloat_len,
                                2 * mt.PRESETS[name].qfloat_ints + 3)})
# JAX's long division, jitted once a shape: High's three, Low's reciprocal,
# and one smaller width at each other base
JAX_DIVISIONS = [(2, 60, 40), (2, 61, 40), (2, 44, 43), (2, 38, 23), (3, 20, 12), (10, 9, 6),
                 (16, 8, 5)]


def divisor_set(rng, n, v_len, p):
    """Random divisors, a few zero, a few with leading zero digits, one
    with only its last digit set."""
    d = digits(rng, (n, v_len), p)
    d[:3] = 0
    d[3:9, : v_len // 2] = 0
    d[9, :-1] = 0
    d[9, -1] = 1
    return d


@functools.lru_cache(maxsize=None)
def jax_division(p):
    return jax.jit(lambda v, d: jax_limbs.base_p_division(v, d, p))


# ---- K6 and K7 built with g++ -----------------------------------------------

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """One g++ build of each kernel's source, and of K6 as first designed
    (``limb_kernels.DIGIT_WINDOW``), all at once; the host entry points."""
    root = tmp_path_factory.mktemp("limb_host")
    builds = {"division": ("limb_division", ()), "tidy": ("limb_tidy", ()),
              "division_digit_window": ("limb_division", limb_kernels.DIGIT_WINDOW)}
    procs = {}
    for key, (name, flags) in builds.items():
        cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", *flags, "-x", "c++",
               "-I", str(CSRC), "-o", str(root / f"{key}.so"), str(CSRC / f"{name}.cu")]
        procs[key] = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
    for key, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ failed for {key}:\n{err}"
    out = {}
    for key, (name, _) in builds.items():
        fn = getattr(ctypes.CDLL(str(root / f"{key}.so")), f"{name}_host")
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                       if name == "limb_division"  # (v, v_stride, d, q, n, d_len, v_len, base)
                       # (in, out, sign or NULL, n, len, base)
                       else [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int])
        fn.restype = ctypes.c_int
        out[key] = fn
    # K6's form with its window in global scratch, past its staged widths
    wide = ctypes.CDLL(str(root / "division.so")).limb_division_wide_host
    wide.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    wide.restype = ctypes.c_int
    out["division_wide"] = wide
    return out


def host_division(host, v, d, p, build="division"):
    """K6's host build on numpy digits: a 1-D dividend is one row shared
    by every divisor (v_stride 0)."""
    d = np.ascontiguousarray(d, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    d_len = v.shape[-1]
    q = np.empty((d.shape[0], d_len), np.int32)
    err = host[build](v.ctypes.data, 0 if v.ndim == 1 else d_len, d.ctypes.data,
                           q.ctypes.data, d.shape[0], d_len, d.shape[-1], p)
    assert err == 0
    return q


def host_division_wide(host, v, d, p):
    """K6's wide form (the window in a scratch array, filled with garbage
    first) on numpy digits, as :func:`host_division`."""
    d = np.ascontiguousarray(d, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    n, d_len, v_len = d.shape[0], v.shape[-1], d.shape[-1]
    q = np.empty((n, d_len), np.int32)
    window = np.full(n * (v_len + 1), -7, np.int32)
    err = host["division_wide"](v.ctypes.data, 0 if v.ndim == 1 else d_len, d.ctypes.data,
                                q.ctypes.data, window.ctypes.data, n, d_len, v_len, p)
    assert err == 0
    return q


def host_tidy(host, arr, p, signed):
    arr = np.ascontiguousarray(arr, np.int32)
    out = np.empty_like(arr)
    sign = np.empty(arr.shape[0], np.int32) if signed else None
    err = host["tidy"](arr.ctypes.data, out.ctypes.data, sign.ctypes.data if signed else None,
                       arr.shape[0], arr.shape[-1], p)
    assert err == 0
    return (out, sign) if signed else out


# ---- the plain functions against JAX -------------------------------------

def test_bcast_batch_and_scan():
    a, b = t(np.zeros((3, 1, 5), np.int32)), t(np.zeros((4, 7), np.int32))
    x, y = limbs._bcast_batch(a, b)
    jx, jy = jax_limbs._bcast_batch(jnp.zeros((3, 1, 5)), jnp.zeros((4, 7)))
    assert x.shape == jx.shape == (3, 4, 5) and y.shape == jy.shape == (3, 4, 7)
    d = np.arange(12, dtype=np.int32).reshape(3, 4)
    step = lambda c, v: (c + v, c * 2 + v)
    carry, ys = limbs._scan_digits(step, t(np.zeros(3, np.int32)), t(d))
    jcarry, jys = jax_limbs._scan_digits(step, jnp.zeros(3, jnp.int32), jnp.asarray(d))
    same((carry, ys), (jcarry, jys))


@pytest.mark.parametrize("p", BASES)
@pytest.mark.parametrize("wa,wb", [(12, 12), (8, 11), (11, 8)])
def test_addition_and_subtraction(p, wa, wb):
    rng = np.random.RandomState(wa * 100 + wb * 10 + p)
    a, b = digits(rng, (64, wa), p), digits(rng, (64, wb), p)
    a[:4] = b[:4, -min(wa, wb):].max()  # some equal tails
    same(limbs.base_p_addition(t(a), t(b), p), jax_limbs.base_p_addition(a, b, p))
    same(limbs.base_p_subtraction(t(a), t(b), p), jax_limbs.base_p_subtraction(a, b, p))
    same(limbs.base_p_subtraction(t(a), t(b), p, overflow=True),
         jax_limbs.base_p_subtraction(a, b, p, True))
    same(limbs.multi_base_p_subtraction(t(b), t(a), p, True),
         jax_limbs.multi_base_p_subtraction(b, a, p, True))
    same(limbs._subtract_full_width(t(a), t(b), p), jax_limbs._subtract_full_width(a, b, p))
    same(limbs._subtract_full_width(t(b), t(a), p), jax_limbs._subtract_full_width(b, a, p))


@pytest.mark.parametrize("p", BASES)
def test_comparisons(p):
    rng = np.random.RandomState(p)
    a, b = digits(rng, (128, 10), p), digits(rng, (128, 10), p)
    b[:16] = a[:16]
    b[16:32, 5:] = a[16:32, 5:]
    for fn in ("is_greater_or_equal", "is_equal", "multi_is_greater_or_equal"):
        same(getattr(limbs, fn)(t(a), t(b)), getattr(jax_limbs, fn)(a, b))
    c = digits(rng, (128, 13), p)
    c[:40, :3] = 0
    c[40:50, :] = 0
    for x, y in ((a, c), (c, a), (a, b)):
        same(limbs.is_greater_or_equal_base_p(t(x), t(y)),
             jax_limbs.is_greater_or_equal_base_p(x, y))
        same(limbs.multi_is_greater_or_equal_base_p(t(x), t(y)),
             jax_limbs.multi_is_greater_or_equal_base_p(x, y))
    signed = rng.randint(-(p - 1), p, size=(128, 9)).astype(np.int32)
    same(limbs.is_positive(t(signed)), jax_limbs.is_positive(signed))


@pytest.mark.parametrize("p", BASES)
@pytest.mark.parametrize("L", TIDY_WIDTHS + [1, 5])
def test_tidies(host, p, L):
    """base_tidy on untidy sums (a multiply's columns, an add's mixed signs),
    tidy_to_sign_mag on its output, and the two in one; K7's host build in
    both modes, on a batch that is not a multiple of its 128-number blocks."""
    rng = np.random.RandomState(p * 1000 + L)
    arr = rng.randint(-2 * L * p * p, 2 * L * p * p, size=(131, L)).astype(np.int32)
    arr[:8] = rng.randint(0, L * (p - 1) ** 2 + 1, size=(8, L))
    arr[8:10] = 0
    tidied = jax_limbs.base_tidy(jnp.asarray(arr), p)
    same(limbs.base_tidy(t(arr), p), tidied)
    same(limbs.multi_base_tidy(t(arr), p), jax_limbs.multi_base_tidy(arr, p))
    same(host_tidy(host, arr, p, False), tidied)
    ref = jax_limbs.tidy_to_sign_mag(tidied, p)
    same(limbs.tidy_to_sign_mag(t(np.asarray(tidied)), p), ref)
    same(limbs.tidy_to_sign_mag(t(arr), p), ref)
    same(host_tidy(host, arr, p, True), ref)


def test_tensor_fast_boolean_mul():
    rng = np.random.RandomState(7)
    x = rng.randint(-50, 50, size=(40, 6)).astype(np.int32)
    flag = rng.randint(0, 2, size=(40, 6)).astype(np.int32)
    same(limbs.tensor_fast_boolean_mul(t(x), t(flag)), jax_limbs.tensor_fast_boolean_mul(x, flag))


@pytest.mark.parametrize("p,d_len,v_len", JAX_DIVISIONS)
def test_division_matches_jax(host, p, d_len, v_len):
    """Full dividends, and a reciprocal's one row broadcast over the batch,
    by divisors with zeros and leading zero digits: the port's division
    (the plain loop on the CPU) and K6's host build."""
    rng = np.random.RandomState(d_len * 100 + v_len + p)
    d = divisor_set(rng, 40, v_len, p)
    v = digits(rng, (40, d_len), p)
    one = np.zeros(d_len, np.int32)
    one[0] = 1
    for dividend in (v, one):
        ref = np.asarray(jax_division(p)(jnp.asarray(np.broadcast_to(dividend, (40, d_len))),
                                         jnp.asarray(d)))
        same(limbs.base_p_division(t(dividend), t(d), p), ref)
        same(limbs.multi_base_p_division(t(dividend), t(d), p), ref)
        same(host_division(host, dividend, d, p), ref)
        np.testing.assert_array_equal(ref, floor_quotient(dividend, d, p))


@pytest.mark.parametrize("name,d_len,v_len", DIVISION_WIDTHS, ids=[w[0] for w in DIVISION_WIDTHS])
def test_division_at_preset_widths(name, d_len, v_len):
    rng = np.random.RandomState(d_len + 7 * v_len)
    d = divisor_set(rng, 24, v_len, 2)
    v = digits(rng, (24, d_len), 2)
    np.testing.assert_array_equal(limbs.base_p_division(t(v), t(d), 2).numpy(),
                                  floor_quotient(v, d, 2))


@pytest.mark.parametrize("name,d_len,v_len", DIVISION_WIDTHS, ids=[w[0] for w in DIVISION_WIDTHS])
def test_k6_host_at_preset_widths(host, name, d_len, v_len):
    rng = np.random.RandomState(d_len + 7 * v_len)
    d = divisor_set(rng, 24, v_len, 2)
    v = digits(rng, (24, d_len), 2)
    np.testing.assert_array_equal(host_division(host, v, d, 2), floor_quotient(v, d, 2))


def widest_divisor(p):
    """The widest divisor whose window takes at most ``MAX_WORDS`` words at
    base ``p``."""
    v_len = 1
    while limb_kernels.window_words(p, v_len + 1) <= limb_kernels.MAX_WORDS:
        v_len += 1
    return v_len


def test_k6_host_window_forms(host):
    """Every compile-time window, one to eight 64-bit words (divisors of 1
    to 256 digits at bases 2 and 7; past eight words the scratch form, as
    the wrapper sends them), and the caps: the entry takes every width the
    wrapper sends it and refuses a window of nine words and rows past the
    staged width."""
    rng = np.random.RandomState(11)
    words = set()
    for v_len in (1, 7, 8, 15, 16, 33, 40, 55, 62, 63, 64, 80, 100, 120, 140, 150, 170, 256):
        for p in (2, 7):
            d = divisor_set(rng, 12, v_len, p)
            v = digits(rng, (12, v_len + 3), p)
            if limb_kernels.scratch_form(v_len + 3, v_len, p):
                got = host_division_wide(host, v, d, p)
            else:
                got = host_division(host, v, d, p)
                words.add(limb_kernels.window_words(p, v_len))
            np.testing.assert_array_equal(got, floor_quotient(v, d, p))
    assert words == set(range(1, limb_kernels.MAX_WORDS + 1))
    q = np.empty((1, 460), np.int32)
    for p in (2, 3, 7, 10, 16, 1000, 2 ** 16 + 1):  # the entry takes what the wrapper sends it
        for v_len in range(1, widest_divisor(p) + 2):
            d = np.zeros((1, v_len), np.int32)
            taken = not limb_kernels.scratch_form(4, v_len, p)
            assert host["division"](q.ctypes.data, 4, d.ctypes.data, q.ctypes.data, 1, 4, v_len,
                                    p) == (0 if taken else 1), (p, v_len)
    widest = widest_divisor(10)  # eight words at base 10: taken; nine: refused
    for d_len, v_len, p, err in ((4, widest + 1, 10, 1), (4, 450, 2, 1), (450, 4, 2, 1),
                                 (4, widest, 10, 0)):
        bad = np.zeros((1, v_len), np.int32)
        assert host["division"](q.ctypes.data, d_len, bad.ctypes.data, q.ctypes.data, 1, d_len,
                                v_len, p) == err


def test_k6_host_wide_form_at_300_digits(host):
    """The form whose window lives in global scratch, at a 300-digit divisor
    (where the first design's window took it): against JAX's
    ``base_p_division`` and Python's floor division at base 2, full
    dividends and a reciprocal's one row; against floor division at base
    7."""
    rng = np.random.RandomState(300)
    v_len = 300
    for p, d_len in ((2, 303), (7, 302)):
        d = divisor_set(rng, 12, v_len, p)
        for v in (digits(rng, (12, d_len), p), np.eye(1, d_len, 0, np.int32)[0]):
            got = host_division_wide(host, v, d, p)
            np.testing.assert_array_equal(got, floor_quotient(v, d, p))
            if p == 2:
                ref = jax_division(p)(jnp.asarray(np.broadcast_to(v, (12, d_len))), jnp.asarray(d))
                same(t(got), ref)
    # the same function as the other forms at their widths
    for v_len, p in ((1, 2), (8, 3), (40, 2), (100, 10)):
        d = divisor_set(rng, 12, v_len, p)
        v = digits(rng, (12, v_len + 5), p)
        np.testing.assert_array_equal(host_division_wide(host, v, d, p),
                                      host_division(host, v, d, p))


def test_k6_wide_divisors_take_the_scratch_form(monkeypatch):
    """The wrapper sends a division whose window passes ``MAX_WORDS`` words,
    or whose rows pass ``MAX_STAGED_DIGITS``, to the wide entry (with a
    scratch window for its N numbers), and the others to the word window;
    the first design's build past 256 digits of divisor (the launch
    recorded, not run)."""
    launched = []
    monkeypatch.setattr(limb_kernels, "_check_device", lambda *tensors: None)
    monkeypatch.setattr(limb_kernels, "_launch",
                        lambda name, *args, device, flags=(), entry=None:
                        launched.append((entry, args[5] if entry else None)))
    v = torch.zeros(5, 260, dtype=torch.int32)
    widest = widest_divisor(10)
    cases = [(v, widest + 1, 10, ()), (v, widest, 10, ()),  # nine words, eight
             (v, 450, 2, ()), (v, 449, 2, ()),  # past the staged rows, at them
             (torch.zeros(5, 450, dtype=torch.int32), 40, 2, ()),
             (v, 257, 2, limb_kernels.DIGIT_WINDOW), (v, 256, 2, limb_kernels.DIGIT_WINDOW)]
    for dividend, v_len, p, flags in cases:
        limb_kernels.limb_division(dividend, torch.ones(5, v_len, dtype=torch.int32), p, flags)
    wide, word = ("limb_division_wide", 5), (None, None)
    assert launched == [wide, word, wide, word, wide, wide, word]


@pytest.mark.parametrize("p", BASES)
def test_k6_host_runtime_window_build(host, p):
    """K6 as first designed (``-DLIMB_DIGIT_WINDOW``: its digit window in
    registers up to 64 digits, at run time in local memory past them; the
    form the card times the word window against) at every preset's
    division widths and past 64 digits, equal to floor division and to the
    word window."""
    rng = np.random.RandomState(90 + p)
    for _, d_len, v_len in DIVISION_WIDTHS + [("wide", 70, 66)]:
        d = divisor_set(rng, 16, v_len, p)
        for v in (digits(rng, (16, d_len), p), digits(rng, (d_len,), p)):
            got = host_division(host, v, d, p, "division_digit_window")
            np.testing.assert_array_equal(got, floor_quotient(v, d, p))
            np.testing.assert_array_equal(got, host_division(host, v, d, p))


def word_boundaries(p):
    """``(d_len, v_len)`` on both sides of every window-word boundary at
    base ``p`` up to the cap: the widest divisor of ``k`` words and the
    narrowest of ``k + 1``, a dividend three digits wider (at most the
    staged width); the last pair takes nine words, past the cap."""
    out, v_len = [], 1
    while len(out) < 2 * limb_kernels.MAX_WORDS:
        while limb_kernels.window_words(p, v_len + 1) == limb_kernels.window_words(p, v_len):
            v_len += 1
        out += [(min(w + 3, limb_kernels.MAX_STAGED_DIGITS), w) for w in (v_len, v_len + 1)]
        v_len += 1
    return out


@pytest.mark.parametrize("p", (2, 3, 7, 10, 16, 1000))
def test_k6_host_at_word_boundaries(host, p):
    """On both sides of every boundary where the window's (v_len + 1) log2 p
    bits cross 64, 128, ... 512 and the cap: the word window (or past the
    cap, or past the staged rows, the wrapper's scratch form) against
    Python's floor division, full dividends and a reciprocal's one row, by
    divisors with zeros, leading zero digits and all digits p - 1; where the
    window first takes two words, against JAX's ``base_p_division`` too
    (its jit unrolls p - 1 rounds a digit: bases up to 16)."""
    rng = np.random.RandomState(1300 + p)
    for k, (d_len, v_len) in enumerate(word_boundaries(p)):
        assert limb_kernels.window_words(p, v_len) == k // 2 + 1 + (k % 2)
        d = divisor_set(rng, 10 if p == 1000 else 14, v_len, p)
        d[-1] = p - 1
        for v in (digits(rng, (d.shape[0], d_len), p), np.eye(1, d_len, 0, np.int32)[0]):
            if limb_kernels.scratch_form(d_len, v_len, p):
                got = host_division_wide(host, v, d, p)
            else:
                got = host_division(host, v, d, p)
            np.testing.assert_array_equal(got, floor_quotient(v, d, p))
            if k == 1 and p <= 16:
                ref = jax_division(p)(jnp.asarray(np.broadcast_to(v, (d.shape[0], d_len))),
                                      jnp.asarray(d))
                same(t(got), ref)


@pytest.mark.parametrize("p", (2, 3, 10, 16, 1000, 2 ** 31 - 1))
def test_k6_host_estimate_edges(host, p):
    """The digit estimate where it is tightest: divisors 1, p**v_len - 1 (all
    digits p - 1) and a power of p; dividends all p - 1 and exact multiples
    of the divisor (a zero remainder, where x = r / d is an integer); every
    digit p - 1; the largest base an int32 digit takes.  Against Python's
    floor division; at bases up to 1,000 also against its first design
    (``-DLIMB_DIGIT_WINDOW``), which has no estimate."""
    rng = np.random.RandomState(p % 1000)
    for d_len, v_len in ((9, 4), (30, 12), (44, 40)):
        if limb_kernels.window_words(p, v_len) > limb_kernels.MAX_WORDS:
            continue
        d = digits(rng, (12, v_len), p)
        d[0] = 0
        d[0, -1] = 1
        d[1] = p - 1
        d[2] = 0
        d[2, v_len // 2] = 1
        v = digits(rng, (12, d_len), p)
        v[:3] = p - 1
        for i in range(3, 8):  # exact multiples: v = d * m
            m = int("".join(str(x) for x in rng.randint(0, 2, size=d_len - v_len)), 2) + 1
            value_ = (value(d[i:i + 1], p)[0] * m) % p ** d_len
            for j in range(d_len - 1, -1, -1):
                v[i, j] = value_ % p
                value_ //= p
        want = floor_quotient(v, d, p)
        np.testing.assert_array_equal(host_division(host, v, d, p), want)
        if p <= 1000:
            np.testing.assert_array_equal(
                host_division(host, v, d, p, "division_digit_window"), want)


@hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
@hypothesis.given(p=st.one_of(st.integers(2, 16), st.integers(17, 1000)), d_len=st.integers(1, 64),
                  v_len=st.integers(1, 48), n=st.integers(1, 140),
                  seed=st.integers(0, 2 ** 31 - 1), one_row=st.booleans())
def test_k6_host_builds_agree(host, p, d_len, v_len, n, seed, one_row):
    """The word window and its first design (digit window) give the same
    quotients, and Python's floor division's, at any base to 1,000, over
    blocks of 128 numbers and their ragged ends."""
    rng = np.random.RandomState(seed)
    d = digits(rng, (n, v_len), p)
    d[: n // 4] = 0
    d[n // 4: n // 2, : rng.randint(0, v_len + 1)] = 0
    v = digits(rng, (d_len,) if one_row else (n, d_len), p)
    got = host_division(host, v, d, p)
    np.testing.assert_array_equal(got, floor_quotient(v, d, p))
    np.testing.assert_array_equal(host_division(host, v, d, p, "division_digit_window"), got)


# limb inversions whose K6 calls are checked: LOW's precision in bases 2, 3
# and 10 (the integer and fraction ranges of LOW's 9 and 14 binary digits),
# and HIGH at n = 2 (the closed form's reciprocal) and n = 3 (true division)
LIMB_INVERSIONS = {
    "low_n3_base2": (mt.LOW.replace(n=3), 3),
    "low_n3_base3": (mt.LOW.replace(n=3, qfloat_base=3, qfloat_len=15, qfloat_ints=6), 3),
    "low_n3_base10": (mt.LOW.replace(n=3, qfloat_base=10, qfloat_len=8, qfloat_ints=3), 3),
    "high_n2_base2": (mt.HIGH.replace(n=2), 2),
    "high_n3_base2": (mt.HIGH.replace(n=3), 3),
}


@pytest.mark.parametrize("name", LIMB_INVERSIONS)
def test_k6_calls_in_limb_inversions_get_tidy_digits(monkeypatch, name):
    """The word window's premise: every long division of a limb inversion
    (``BatchedMatrixInversion(..., backend="limb", device="cpu")``) gets
    dividend and divisor digits in ``[0, p)``, on matrices that are random,
    all zero (zero divisors) and singular.  (``QFloat.base_tidy`` alone
    leaves digits in ``]-p, p[``, where a window in words would not give
    the digit chain's quotient; no division sees one.)"""
    params, n = LIMB_INVERSIONS[name]
    seen = []
    divide = limbs.base_p_division

    def division(dividend, divisor, p):
        seen.append((p, int(min(dividend.min(), divisor.min())),
                     int(max(dividend.max(), divisor.max()))))
        return divide(dividend, divisor, p)

    monkeypatch.setattr(limbs, "base_p_division", division)
    rng = np.random.RandomState(130 + n)
    M = rng.standard_normal((6, n, n)) * 4
    M[1] = 0
    M[2, 1] = 2 * M[2, 0]
    inv = mt.BatchedMatrixInversion(params, 6, backend="limb", device="cpu")
    assert inv.backend == "limb"
    inv.run(M)
    assert seen
    for p, low, high in seen:
        assert p == params.qfloat_base and 0 <= low and high < p, (p, low, high)


@pytest.mark.parametrize("p", BASES)
def test_k7_host_past_its_staged_width(host, p):
    """Rows at and past K7's widest staged row (95 digits), where it walks
    the digits in place, against the plain versions."""
    rng = np.random.RandomState(70 + p)
    for L in (95, 96, 130):
        arr = rng.randint(-2 * L * p * p, 2 * L * p * p, size=(131, L)).astype(np.int32)
        tidied = limbs.base_tidy_reference(t(arr), p)
        same(host_tidy(host, arr, p, False), tidied)
        same(host_tidy(host, arr, p, True), limbs.tidy_to_sign_mag_reference(tidied, p))


@hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
@hypothesis.given(p=st.integers(2, 16), d_len=st.integers(1, 64), v_len=st.integers(1, 64),
                  n=st.integers(1, 9), seed=st.integers(0, 2 ** 31 - 1), one_row=st.booleans())
def test_k6_host_property(host, p, d_len, v_len, n, seed, one_row):
    rng = np.random.RandomState(seed)
    d = digits(rng, (n, v_len), p)
    d[: n // 3] = 0
    d[n // 3: 2 * n // 3, : rng.randint(0, v_len + 1)] = 0
    v = digits(rng, (d_len,) if one_row else (n, d_len), p)
    got = host_division(host, v, d, p)
    np.testing.assert_array_equal(got, limbs.base_p_division_reference(t(v), t(d), p).numpy())


@hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
@hypothesis.given(p=st.integers(2, 16), L=st.integers(1, 64), n=st.integers(1, 300),
                  seed=st.integers(0, 2 ** 31 - 1))
def test_k7_host_property(host, p, L, n, seed):
    rng = np.random.RandomState(seed)
    arr = rng.randint(-3 * p * p, 3 * p * p, size=(n, L)).astype(np.int32)
    tidied = limbs.base_tidy_reference(t(arr), p)
    np.testing.assert_array_equal(host_tidy(host, arr, p, False), tidied.numpy())
    mag, sign = limbs.tidy_to_sign_mag_reference(tidied, p)
    got_mag, got_sign = host_tidy(host, arr, p, True)
    np.testing.assert_array_equal(got_mag, mag.numpy())
    np.testing.assert_array_equal(got_sign, sign.numpy())


# ---- the wrappers and the routing ---------------------------------------

def test_wrappers_check_their_inputs():
    v, d = torch.zeros(3, 6, dtype=torch.int32), torch.ones(3, 4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        limb_kernels.limb_division(v.long(), d, 2)
    with pytest.raises(TypeError, match="int32"):
        limb_kernels.limb_tidy(v.long(), 2)
    # no cap on the divisor's width: a 257-digit one is refused only for its device
    with pytest.raises(ValueError, match="expected CUDA"):
        limb_kernels.limb_division(v, torch.ones(3, 257, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="base"):
        limb_kernels.limb_division(v, d, 1)
    with pytest.raises(ValueError, match="two devices"):
        limb_kernels.limb_division(v, d.to("meta"), 2)
    # the plain versions are ops/limbs.py's: the wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="expected CUDA"):
        limb_kernels.limb_division(v, d, 2)
    with pytest.raises(ValueError, match="expected CUDA"):
        limb_kernels.limb_tidy(v, 2, signed=True)
    with pytest.raises(ValueError, match="expected CUDA"):
        limb_kernels.limb_tidy(v.to("meta"), 2)
    with pytest.raises(ValueError, match="digit axis"):
        limb_kernels.limb_tidy(torch.zeros((), dtype=torch.int32), 2)


def test_chains_route_to_the_kernels(monkeypatch):
    """A tensor that ``ops.packed._to_kernel`` sends to a kernel goes to K6
    and K7's wrappers, one call a division, a tidy, and a tidy with its
    sign; inside ``plain_arithmetic()`` none does."""
    calls = []
    monkeypatch.setattr(packed, "_to_kernel", lambda x: not getattr(packed._PLAIN, "on", False))
    monkeypatch.setattr(limb_kernels, "limb_division",
                        lambda *a: calls.append("K6") or limbs.base_p_division_reference(*a))

    def tidy(arr, base, signed=False):
        calls.append("K7 sign" if signed else "K7")
        tidied = limbs.base_tidy_reference(arr, base)
        return limbs.tidy_to_sign_mag_reference(tidied, base) if signed else tidied

    monkeypatch.setattr(limb_kernels, "limb_tidy", tidy)
    a = mt.QFloat(t(np.array([[0, 1, 1, 0], [1, 0, 0, 1]], np.int32)), 2, 2)
    b = mt.QFloat(t(np.array([[0, 0, 1, 1], [0, 1, 1, 0]], np.int32)), 2, 2)
    a / b
    a * b
    a + b
    a.copy().tidy()
    assert calls == ["K6", "K7", "K7 sign", "K7 sign"]
    calls.clear()
    with packed.plain_arithmetic():
        a / b, a * b, a + b
    assert calls == []
