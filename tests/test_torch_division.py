"""The division kernels (K2, K3), the windowed-multiply kernel (K4) and
their routing, on the CPU.

``csrc/long_division.cu`` and ``csrc/mul_window.cu`` compile as host C++
when ``__CUDACC__`` is not defined: the same per-element functions, with a
loop in place of the launch.  Built here with g++ (``-ffp-contract=off``,
as K2's rounding argument needs), they are held with tolerance 0 against
Python-int floor division, against the JAX package's XLA float division,
and against its Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them; K4 also against the port's truncated
multiply and windowed sum, at the presets' multiply formats, formats that
take each of its word widths, and any base-2 format hypothesis picks.  The
division inputs sit on the floor boundaries where an unfixed f32 estimate
would be off by one, at the divide and invert widths of every preset, with
zero divisors and the widest divisor the exactness argument allows; on the
divisors where K3's integer reciprocal could slip (around 2**32, powers of
two, 1, 2**61 and above); and anywhere hypothesis looks.
``csrc/long_division_steps.cu`` keeps the first K2, K3 and K4 for timing:
they must agree with the present ones.
"""

import ctypes
import subprocess
import threading

import hypothesis
import hypothesis.strategies as st

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_inversion_tpu.ops import packed as jax_packed
from matrix_inversion_tpu.ops import pallas_kernels as pk

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core.qfloat import qf_from_mul
from matrix_inversion_tpu_torch.ops import fused_inverse, long_division, packed
from matrix_inversion_tpu_torch.ops.cuda_build import CSRC
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat, track_overflow
from matrix_inversion_tpu_torch.utils import division_steps, profiling

torch.set_num_threads(2)


def _shapes():
    """``(name, n_bits, divisor_bits)`` of every division the circuits run:
    each preset's true division (``len + frac`` digits by ``len``), its
    reciprocal (``1 + frac + len`` by ``len``) and the 2x2 closed form's
    determinant reciprocal (``(2*ints + 3, 2*ints)`` to ``(len, 0)``)."""
    out = []
    for name in ("low", "medium", "high"):
        p = mt.PRESETS[name]
        length, frac = p.qfloat_len, p.frac
        out += [
            (f"{name}_divide", length + frac, length),
            (f"{name}_invert", 1 + frac + length, length),
            (f"{name}_invert_2x2", 1 + 3 + length, 2 * p.qfloat_ints + 3),
        ]
    return out


SHAPES = _shapes()
SHAPE_IDS = [s[0] for s in SHAPES]


def boundary_inputs(n_bits, divisor_bits, seed, n_random=1500):
    """Random draws plus the fixup-boundary set of
    tests/test_pair_qfloat.py::test_div_float_fixup_bound (v = q*d,
    q*d - 1, q*d + d - 1), zero divisors, the widest divisor
    2**divisor_bits - 1 and the widest dividend."""
    rng = np.random.RandomState(seed)
    vmax = (1 << n_bits) - 1
    dmax = (1 << divisor_bits) - 1
    vs = [int(x) & vmax for x in rng.randint(0, 1 << 62, size=n_random, dtype=np.int64)]
    ds = [int(x) & dmax for x in rng.randint(0, 1 << 62, size=n_random, dtype=np.int64)]
    for _ in range(600):
        d = min(int(rng.randint(1, 1 << 31)) * int(rng.randint(1, 1 << 9)) + 1, dmax)
        d = d >> int(rng.randint(0, 24))
        q = int(rng.randint(0, 1 << 20)) << int(rng.randint(0, 40))
        for v in (q * d, q * d - 1, q * d + d - 1):
            if 0 <= v <= vmax and d > 0:
                vs.append(v)
                ds.append(d)
    vs += [vmax, vmax, vmax, vmax, 0, 1, vmax, 12345]
    ds += [1, 2, dmax, dmax - 1, 5, 1, 0, 0]
    return np.array(vs, np.int64), np.array(ds, np.int64)


def floor_div(vs, ds, n_bits):
    return np.array(
        [v // d if d else (1 << n_bits) - 1 for v, d in zip(vs.tolist(), ds.tolist())],
        np.int64,
    )


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """One g++ build per source, all at once; the host launch functions."""
    root = tmp_path_factory.mktemp("division_host")
    procs = {}
    for name in ("long_division", "mul_window", "long_division_steps"):
        cmd = [
            "g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
            "-x", "c++", "-I", str(CSRC), "-o", str(root / f"{name}.so"),
            str(CSRC / f"{name}.cu"),
        ]
        procs[name] = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ failed for {name}:\n{err}"
    div = ctypes.CDLL(str(root / "long_division.so"))
    mul = ctypes.CDLL(str(root / "mul_window.so"))
    fns = {
        "float": div.long_division_float_host,
        "classic": div.long_division_classic_host,
        "mul": mul.mul_window_host,
        "step": ctypes.CDLL(str(root / "long_division_steps.so")).division_step_host,
        "mul_step": ctypes.CDLL(str(root / "long_division_steps.so")).mul_step_host,
    }
    # (v, d, q, n, v_stride, then n_bits and k, or n_digits and bits; K4:
    # a, b, out, n, a_stride, t1, nt, newlength)
    for key in ("float", "classic"):
        fns[key].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 3
    fns["mul"].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 4
    fns["step"].argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 3
    fns["mul_step"].argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [
        ctypes.c_int] * 4 + [ctypes.POINTER(division_steps.MulWindowTable)]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def run_host(fn, x, y, *args):
    """The host launch of a kernel of the streaming frame: one ``x`` per
    ``y`` (stride 1) or, where ``x`` is a single word, stride 0."""
    x, y = np.ascontiguousarray(x, np.int64), np.ascontiguousarray(y, np.int64)
    out = np.empty_like(y)
    if args and isinstance(args[0], int):
        args = (int(x.size == y.size),) + args
    assert x.size in (1, y.size)
    assert fn(x.ctypes.data, y.ctypes.data, out.ctypes.data, y.size, *args) == 0
    return out


def run_mul_step(fn, frame, op, a, b, formats):
    """The host launch of multiply step ``op`` in frame ``frame``, or None
    where the steps library does not hold that pair."""
    a, b = np.ascontiguousarray(a, np.int64), np.ascontiguousarray(b, np.int64)
    out = np.empty_like(b)
    err = fn(frame, op, a.ctypes.data, b.ctypes.data, out.ctypes.data, b.size,
             int(a.size == b.size), *division_steps.mul_step_args(*formats))
    assert err in (0, -1)
    return out if err == 0 else None


def run_step(fn, frame, op, x, y, n_bits, k=15):
    x, y = np.ascontiguousarray(x, np.int64), np.ascontiguousarray(y, np.int64)
    out = np.empty_like(y)
    assert fn(frame, op, x.ctypes.data, y.ctypes.data, out.ctypes.data, y.size,
              int(x.size == y.size), n_bits, k) == 0
    return out


def as_int64(values):
    """Python ints below 2**64 as the int64 words that hold their bits."""
    return np.array(values, dtype=np.uint64).view(np.int64)


@pytest.mark.parametrize("name,n_bits,divisor_bits", SHAPES, ids=SHAPE_IDS)
def test_chunk_bits_match_jax(name, n_bits, divisor_bits):
    k = packed._float_div_chunk_bits(n_bits, divisor_bits)
    assert k == jax_packed._float_div_chunk_bits(n_bits, divisor_bits) == 15
    for nb, db in ((62, 47), (62, 58), (20, 57), (3, 10), (61, None), (40, 61)):
        assert packed._float_div_chunk_bits(nb, db) == jax_packed._float_div_chunk_bits(nb, db)


@pytest.mark.parametrize("name,n_bits,divisor_bits", SHAPES, ids=SHAPE_IDS)
def test_float_division_host_exact(host, name, n_bits, divisor_bits):
    """K2 == Python-int floor division == JAX's XLA float division."""
    k = packed._float_div_chunk_bits(n_bits, divisor_bits)
    vs, ds = boundary_inputs(n_bits, divisor_bits, seed=n_bits + divisor_bits)
    got = run_host(host["float"], vs, ds, n_bits, k)
    np.testing.assert_array_equal(got, floor_div(vs, ds, n_bits))
    ref = jax_packed._long_division_float(jnp.asarray(vs), jnp.asarray(ds), n_bits, k)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("name,n_bits,divisor_bits", SHAPES, ids=SHAPE_IDS)
def test_classic_division_host_exact(host, name, n_bits, divisor_bits, bits):
    """K3 == Python-int floor division at base 2, 4 and 16 (digit widths
    that divide the dividend's width; the others round it down)."""
    n_bits -= n_bits % bits
    vs, ds = boundary_inputs(n_bits, min(divisor_bits, n_bits), seed=bits, n_random=600)
    got = run_host(host["classic"], vs, ds, n_bits // bits, bits)
    np.testing.assert_array_equal(got, floor_div(vs, ds, n_bits))


@pytest.mark.parametrize("name,n_bits,divisor_bits", [SHAPES[i] for i in (0, 6, 7)],
                         ids=[SHAPE_IDS[i] for i in (0, 6, 7)])
def test_division_host_matches_pallas_interpret(host, name, n_bits, divisor_bits):
    """K2 and K3 == the JAX package's Pallas kernels in interpret mode (K3
    also at base 4 where the width allows), with a broadcast scalar
    dividend (the reciprocal's shape) as well."""
    k = packed._float_div_chunk_bits(n_bits, divisor_bits)
    vs, ds = boundary_inputs(n_bits, divisor_bits, seed=3, n_random=300)
    ref_float = np.asarray(pk.batched_long_division_float(
        jnp.asarray(vs), jnp.asarray(ds), n_bits, k, interpret=True))
    ref_classic = np.asarray(pk.batched_long_division(
        jnp.asarray(vs), jnp.asarray(ds), n_bits, 1, interpret=True))
    np.testing.assert_array_equal(run_host(host["float"], vs, ds, n_bits, k), ref_float)
    np.testing.assert_array_equal(run_host(host["classic"], vs, ds, n_bits, 1), ref_classic)
    if n_bits % 2 == 0:
        ref_base4 = np.asarray(pk.batched_long_division(
            jnp.asarray(vs), jnp.asarray(ds), n_bits // 2, 2, interpret=True))
        np.testing.assert_array_equal(run_host(host["classic"], vs, ds, n_bits // 2, 2), ref_base4)
    one = 1 << (n_bits - 1)
    ref_scalar = np.asarray(pk.batched_long_division_float(
        jnp.asarray(one, jnp.int64), jnp.asarray(ds), n_bits, k, interpret=True))
    got_scalar = run_host(host["float"], [one], ds, n_bits, k)  # stride 0
    np.testing.assert_array_equal(got_scalar, ref_scalar)
    np.testing.assert_array_equal(run_host(host["float"], np.full_like(ds, one), ds, n_bits, k),
                                  ref_scalar)
    ref_classic_scalar = np.asarray(pk.batched_long_division(
        jnp.asarray(one, jnp.int64), jnp.asarray(ds), n_bits, 1, interpret=True))
    np.testing.assert_array_equal(run_host(host["classic"], [one], ds, n_bits, 1),
                                  ref_classic_scalar)
    np.testing.assert_array_equal(
        long_division.batched_long_division_float(
            torch.tensor(one), torch.from_numpy(ds), n_bits, k).numpy(),
        ref_scalar,
    )


# Divisors where an integer reciprocal, a normalising shift or a truncated
# remainder could slip.
EDGE_DIVISORS = {
    "around_2_32": [(1 << 32) + o for o in range(-3, 4)] + [(1 << 33) - 1, (1 << 31) + 1],
    "powers_of_two": [1 << b for b in range(0, 62)],
    "one_two_three": [1, 2, 3],
    "all_ones": [(1 << b) - 1 for b in range(1, 63)],
    "wide": [(1 << 61) + o for o in (-1, 0, 1)] + [(1 << 62) - 1, 1 << 62, (1 << 63) - 1,
                                                  1 << 63, (1 << 64) - 1],
    "zero": [0],
    "top_word_all_ones": [((1 << 32) - 1) << s for s in (0, 7, 29)] + [(1 << 61) - (1 << 20)],
}


def edge_dividends(d, n_bits, rng):
    """Dividends on d's floor boundaries, the widest, and random ones."""
    vmax = (1 << n_bits) - 1
    vs = [0, 1, vmax, vmax - 1, vmax >> 1]
    for _ in range(24):
        q = int(rng.randint(0, 1 << 31)) * int(rng.randint(0, 1 << 31)) >> int(rng.randint(0, 62))
        vs += [q * d - 1, q * d, q * d + d - 1, int(rng.randint(0, 1 << 62))]
    return [v & vmax for v in vs if v >= 0]


@pytest.mark.parametrize("n_bits", [62, 61, 60, 38, 31, 32, 5, 1])
@pytest.mark.parametrize("kind", list(EDGE_DIVISORS))
def test_classic_division_edge_divisors(host, kind, n_bits):
    """K3 == Python-int floor division on the divisors its reciprocal and
    its shifts could get wrong, at widths on both sides of one 31-bit digit."""
    rng = np.random.RandomState(n_bits)
    vs, ds = [], []
    for d in EDGE_DIVISORS[kind]:
        for v in edge_dividends(d, n_bits, rng):
            vs.append(v)
            ds.append(d)
    want = as_int64([v // d if d else (1 << n_bits) - 1 for v, d in zip(vs, ds)])
    got = run_host(host["classic"], as_int64(vs), as_int64(ds), n_bits, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,n_bits,divisor_bits", SHAPES, ids=SHAPE_IDS)
def test_float_division_edge_divisors(host, name, n_bits, divisor_bits):
    """K2 == Python-int floor division on the floor boundaries of the
    divisors where its remainder is cut to 32 bits from the most bits
    (the widest), from none (short ones), and at powers of two."""
    rng = np.random.RandomState(n_bits)
    k = packed._float_div_chunk_bits(n_bits, divisor_bits)
    dmax = (1 << divisor_bits) - 1
    vs, ds = [], []
    for kind in ("around_2_32", "powers_of_two", "one_two_three", "all_ones", "zero",
                 "top_word_all_ones"):
        for d in EDGE_DIVISORS[kind] + [dmax, dmax - 1, (dmax >> 1) + 1]:
            if d <= dmax:
                for v in edge_dividends(d, n_bits, rng):
                    vs.append(v)
                    ds.append(d)
    want = as_int64([v // d if d else (1 << n_bits) - 1 for v, d in zip(vs, ds)])
    np.testing.assert_array_equal(run_host(host["float"], as_int64(vs), as_int64(ds), n_bits, k), want)
    # the run-time form of the same pair (k = 14 has no compile-time instance)
    if 61 - divisor_bits >= 14:
        np.testing.assert_array_equal(
            run_host(host["float"], as_int64(vs), as_int64(ds), n_bits, 14), want)


@hypothesis.settings(max_examples=300, deadline=None)
@hypothesis.given(v=st.integers(0, (1 << 64) - 1), d=st.integers(0, (1 << 64) - 1),
                  n_bits=st.integers(1, 62), shift=st.integers(0, 63))
def test_classic_division_property(host, v, d, n_bits, shift):
    """K3 == floor division of the dividend's low n_bits, for any words."""
    d >>= shift
    want = (v & ((1 << n_bits) - 1)) // d if d else (1 << n_bits) - 1
    assert run_host(host["classic"], as_int64([v]), as_int64([d]), n_bits, 1)[0] == want


@hypothesis.settings(max_examples=300, deadline=None)
@hypothesis.given(v=st.integers(0, (1 << 62) - 1), d=st.integers(0, (1 << 57) - 1),
                  n_bits=st.integers(4, 62), divisor_bits=st.integers(1, 57),
                  boundary=st.sampled_from([None, -1, 0, 1]))
def test_float_division_property(host, v, d, n_bits, divisor_bits, boundary):
    """K2 == floor division wherever _float_div_chunk_bits lets it run,
    also right on, just under and at the far end of a quotient's range."""
    k = packed._float_div_chunk_bits(n_bits, divisor_bits)
    hypothesis.assume(k)
    d &= (1 << divisor_bits) - 1
    v &= (1 << n_bits) - 1
    if boundary is not None and d:
        v = max(0, (v // d) * d + (d - 1 if boundary == 1 else boundary))
        v &= (1 << n_bits) - 1
    want = v // d if d else (1 << n_bits) - 1
    assert run_host(host["float"], as_int64([v]), as_int64([d]), n_bits, k)[0] == want


@pytest.mark.parametrize("name,n_bits,divisor_bits", SHAPES, ids=SHAPE_IDS)
def test_division_ignores_bits_above_n_bits(host, name, n_bits, divisor_bits):
    """Neither kernel reads the dividend's bits above n_bits."""
    k = packed._float_div_chunk_bits(n_bits, divisor_bits)
    vs, ds = boundary_inputs(n_bits, divisor_bits, seed=7, n_random=200)
    rng = np.random.RandomState(8)
    high = as_int64([(int(x) << n_bits) & ((1 << 64) - 1)
                     for x in rng.randint(0, 1 << 30, size=len(vs))])
    want = floor_div(vs, ds, n_bits)
    np.testing.assert_array_equal(run_host(host["float"], vs | high, ds, n_bits, k), want)
    np.testing.assert_array_equal(run_host(host["classic"], vs | high, ds, n_bits, 1), want)


@pytest.mark.parametrize("n", [1, 2, 3, 1025])
def test_division_host_lengths_and_strides(host, n):
    """Odd and even lengths, with one dividend per divisor and with a
    one-word dividend (stride 0), through both host launches."""
    vs, ds = boundary_inputs(60, 40, seed=n, n_random=n)
    vs, ds = vs[:n], ds[:n]
    for key, args in (("float", (60, 15)), ("classic", (60, 1)), ("classic", (30, 2))):
        np.testing.assert_array_equal(run_host(host[key], vs, ds, *args), floor_div(vs, ds, 60))
        np.testing.assert_array_equal(
            run_host(host[key], vs[:1], ds, *args), floor_div(np.full_like(ds, vs[0]), ds, 60))


@pytest.mark.parametrize("name,n_bits,divisor_bits", [SHAPES[i] for i in (6, 7)],
                         ids=[SHAPE_IDS[i] for i in (6, 7)])
def test_first_kernels_agree_with_present_ones(host, name, n_bits, divisor_bits):
    """The element functions kept for timing in long_division_steps.cu
    (the first K2 and K3, the machine's own ``/``) == the present K2 and K3,
    whichever frame is asked for."""
    vs, ds = boundary_inputs(n_bits, divisor_bits, seed=11, n_random=400)
    want = floor_div(vs, ds, n_bits)
    for op in division_steps.OPS.values():
        for frame in division_steps.FRAMES.values():
            np.testing.assert_array_equal(run_step(host["step"], frame, op, vs, ds, n_bits), want)
        np.testing.assert_array_equal(
            run_step(host["step"], 2, op, vs[:1], ds, n_bits),
            floor_div(np.full_like(ds, vs[0]), ds, n_bits))
    out = np.empty_like(ds)
    refused = host["step"](2, 3, vs.ctypes.data, ds.ctypes.data, out.ctypes.data, len(ds), 1, 59, 15)
    assert refused == -1 and host["step"](3, 0, 0, 0, 0, 0, 1, 60, 15) == -1


# (len, ints) of a and b and the output: tests/test_pallas.py:80-83 (there
# written (ints, len)), and asymmetric formats, so that a swap of the
# length and integer-digit arguments shows; then the presets' own multiplies
# (High's dot product, Medium's and Medium+'s, Medium's multiply by an
# integer-free operand, Low's second; its first is above), each a
# compile-time instance of K4.
# Between them they take every word width of K4: C in 32 bits and 64, the
# product in 64 bits and 128, the widening t1 <= 0.
MUL_FORMATS = [
    ((40, 16), (40, 16), (40, 16)),
    ((40, 16), (40, 0), (40, 16)),
    ((23, 9), (23, 9), (23, 9)),
    ((23, 9), (23, 9), (21, 21)),
    ((31, 12), (23, 5), (27, 10)),
    ((43, 40), (43, 40), (40, 0)),
    ((62, 62), (62, 62), (62, 62)),
    ((40, 20), (40, 20), (40, 20)),
    ((31, 16), (31, 16), (31, 16)),
    ((31, 16), (31, 0), (31, 16)),
    ((23, 9), (23, 0), (23, 9)),
]


@pytest.mark.parametrize("a_fmt,b_fmt,out_fmt", MUL_FORMATS)
def test_first_mul_kernel_agrees_with_present_one(host, a_fmt, b_fmt, out_fmt):
    """The multiply's element functions kept for timing in
    long_division_steps.cu (the first K4 from its row table, the algebra in
    128 bits, the 32-bit correction at run time, High's instance) == the
    port's K4, whichever frame is asked for, also with a one-word a; the
    32-bit correction is refused where C or the product does not fit its
    words, High's instance at any other format."""
    (al, ai), (bl, bi), (nl, ni) = a_fmt, b_fmt, out_fmt
    fmt = long_division.mul_trunc_format(al, ai, bl, bi, nl, ni)
    a, b = mul_operands(al, bl, 300, 5)
    want, want_one = run_host(host["mul"], a, b, *fmt), run_host(host["mul"], a[7:8], b, *fmt)
    held = set()
    for op in division_steps.MUL_OPS.values():
        for frame in division_steps.FRAMES.values():
            got = run_mul_step(host["mul_step"], frame, op, a, b, (a_fmt, b_fmt, out_fmt))
            if got is not None:
                held.add(op)
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(
                    run_mul_step(host["mul_step"], frame, op, a[7:8], b, (a_fmt, b_fmt, out_fmt)),
                    want_one)
    t1, nt, _ = fmt
    if t1 <= 0:
        assert held == set()
        return
    fits = t1 + nl <= 64 and t1 + 1 + nt.bit_length() <= 32
    assert held == {0, 1} | ({2} if fits else set()) | ({3} if fmt == (20, 20, 40) else set())


def test_design_steps_name_real_frames_and_ops():
    for _, frame, op in division_steps.STEPS:
        assert frame in division_steps.FRAMES and op in division_steps.OPS
    with pytest.raises(ValueError, match="CUDA tensors only"):
        division_steps.run_step("streaming, 2 pairs", "K3", torch.tensor(8), torch.tensor([3]), 60, 15)
    for _, frame, op in division_steps.MUL_STEPS:
        assert frame in division_steps.FRAMES and op in division_steps.MUL_OPS
    with pytest.raises(ValueError, match="CUDA tensors only"):
        division_steps.run_mul_step("streaming, 2 pairs", "first K4", torch.tensor([8]),
                                    torch.tensor([3]))
    # each step's kernel is found by name among the library's mangled ones
    names = [f"_ZN6sframe{k}EN{t}EEEvPKmiS5_Pml"
             for k in ("13scalar_kernelI", "13stream_kernelILi1E", "13stream_kernelILi2E")
             for t in ("8divsteps8FirstMulE", "6mulwin8TruncAnyIooE", "6mulwin8TruncAnyIjmE",
                       "6mulwin10TruncFixedILi20ELi20ELi40EE")]
    for _, frame, op in division_steps.MUL_STEPS:
        assert division_steps.kernel_name(names, frame, op) in names


def testdivision_operands():
    """A one-word dividend keeps its one address (stride 0); anything else
    is laid out beside the divisor (stride 1); the divisor is contiguous in
    the broadcast shape."""
    d = torch.arange(1, 13).reshape(3, 4)
    word = torch.tensor(77)
    for dividend in (word, word.reshape(1, 1), word.expand(3, 4), torch.tensor([77])[0:1]):
        v, stride, dd = long_division.division_operands(dividend, d)
        assert stride == 0 and v.data_ptr() == dividend.data_ptr() and dd.shape == (3, 4)
    row = torch.arange(4)
    v, stride, dd = long_division.division_operands(row, d.t().contiguous().t())
    assert stride == 1 and v.shape == dd.shape == (3, 4) and v.is_contiguous() and dd.is_contiguous()
    v, stride, dd = long_division.division_operands(d, torch.tensor(5))
    assert stride == 1 and dd.shape == (3, 4) and dd.is_contiguous() and int(dd[2, 3]) == 5
    v, stride, dd = long_division.division_operands(torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64))
    assert stride == 1 and dd.numel() == 0


@pytest.mark.parametrize("fmt,newlength,newints", [((40, 20), 40, 0), ((23, 9), 23, 0),
                                                    ((43, 40), 40, 0), ((31, 16), 20, 5)])
def test_invert_passes_one_word_and_matches_jax(monkeypatch, kernel_route, fmt, newlength, newints):
    """On the kernel route ``invert`` hands the division one 0-dim word, made
    once per value and device and never filled to the batch; values, signs
    and the overflow flags equal JAX's ``invert`` bit for bit."""
    from matrix_inversion_tpu.ops.packed import PackedQFloat as JPacked
    from matrix_inversion_tpu.ops.packed import track_overflow as jax_track

    rng = np.random.RandomState(sum(fmt))
    mags = rng.randint(0, 1 << 62, size=96, dtype=np.int64) & ((1 << fmt[0]) - 1)
    mags[:24] = rng.randint(0, 4, size=24)  # tiny and zero divisors: they overflow
    signs = rng.choice([-1, 0, 1], size=96)
    seen = []
    wrapper = long_division.batched_long_division_float

    def spy(dividend, divisor, n_bits, k):
        seen.append(dividend)
        return wrapper(dividend, divisor, n_bits, k)

    monkeypatch.setattr(long_division, "batched_long_division_float", spy)
    monkeypatch.setattr(torch, "full_like", lambda *a, **kw: pytest.fail("invert filled a tensor"))
    t = PackedQFloat(torch.from_numpy(mags), *fmt, 2, torch.from_numpy(signs))
    j = JPacked(jnp.asarray(mags), *fmt, 2, jnp.asarray(signs))
    with track_overflow() as tt:
        tq = t.invert(1, newlength, newints)
        tq2 = t.invert(-1, newlength, newints)
    with jax_track() as jt:
        jq = j.invert(1, newlength, newints)
    assert len(seen) == 2 and seen[0].dim() == 0 and seen[0] is seen[1]
    assert int(seen[0]) == 1 << ((fmt[0] - fmt[1]) + (newlength - newints))
    np.testing.assert_array_equal(tq.mag.numpy(), np.asarray(jq.mag))
    np.testing.assert_array_equal(tq.sign.numpy(), np.asarray(jq.sign))
    assert torch.equal(tq2.mag, tq.mag) and torch.equal(tq2.sign, -tq.sign)
    flags = tt.combined((96,))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jt.combined((96,))))
    assert 0 < int(flags.sum()) < 96



def mul_operands(a_len, b_len, size, seed):
    """Random magnitudes of a and b, with zeros and all-ones words among
    them."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << 62, size=size, dtype=np.int64) & ((1 << a_len) - 1)
    b = rng.randint(0, 1 << 62, size=size, dtype=np.int64) & ((1 << b_len) - 1)
    a[:2], b[2:4], a[4:6], b[4] = 0, (1 << b_len) - 1, (1 << a_len) - 1, 0
    return a, b


@pytest.mark.parametrize("a_fmt,b_fmt,out_fmt", MUL_FORMATS)
def test_mul_window_host_exact(host, a_fmt, b_fmt, out_fmt):
    """K4 == JAX's Pallas kernel in interpret mode == the port's truncated
    multiply == its windowed sum masked, also with a one-word a (stride 0);
    the first K4's table (the steps library's) == JAX's."""
    (al, ai), (bl, bi), (nl, ni) = a_fmt, b_fmt, out_fmt
    a, b = mul_operands(al, bl, 500, al + bl + nl)
    consts = packed.mul_window_consts(al, ai, bl, bi, nl, ni, 1)
    jax_consts = jax_packed._mul_window_consts(ai, al, bi, bl, nl, ni, 1)
    assert [tuple(map(int, row)) for row in zip(*jax_consts)] == consts
    fmt = long_division.mul_trunc_format(al, ai, bl, bi, nl, ni)
    got = run_host(host["mul"], a, b, *fmt)
    ref = pk.batched_mul_window(jnp.asarray(a), jnp.asarray(b), jax_consts, nl, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    trunc = packed.mul_trunc_packed(ta, al, ai, tb, bl, bi, nl, ni, 1)
    np.testing.assert_array_equal(got, trunc.numpy())
    window = packed.mul_window_sum(ta, tb, consts, 1) & ((1 << nl) - 1)
    np.testing.assert_array_equal(got, window.numpy())
    np.testing.assert_array_equal(
        long_division.batched_mul_window(ta, tb, al, ai, bl, bi, nl, ni).numpy(), got)
    one = int(a[7])
    want = packed.mul_trunc_packed(torch.full_like(tb, one), al, ai, tb, bl, bi, nl, ni, 1)
    np.testing.assert_array_equal(run_host(host["mul"], a[7:8], b, *fmt), want.numpy())
    np.testing.assert_array_equal(
        long_division.batched_mul_window(torch.tensor(one), tb, al, ai, bl, bi, nl, ni).numpy(),
        want.numpy())


@hypothesis.settings(max_examples=300, deadline=None)
@hypothesis.given(
    a_fmt=st.integers(1, 62).flatmap(lambda n: st.tuples(st.just(n), st.integers(0, n))),
    b_fmt=st.integers(1, 62).flatmap(lambda n: st.tuples(st.just(n), st.integers(0, n))),
    out_fmt=st.integers(1, 62).flatmap(lambda n: st.tuples(st.just(n), st.integers(0, n))),
    words=st.lists(st.tuples(st.sampled_from(["zero", "ones", "random"]),
                             st.sampled_from(["zero", "ones", "random"]),
                             st.integers(0, (1 << 62) - 1), st.integers(0, (1 << 62) - 1)),
                   min_size=1, max_size=6))
def test_mul_window_host_property(host, a_fmt, b_fmt, out_fmt, words):
    """K4 == the windowed sum masked == the truncated multiply at any base-2
    format of at most 62 digits, on zeros, all-ones words and random ones."""
    (al, ai), (bl, bi), (nl, ni) = a_fmt, b_fmt, out_fmt
    pick = {"zero": lambda n, r: 0, "ones": lambda n, r: (1 << n) - 1,
            "random": lambda n, r: r & ((1 << n) - 1)}
    a = np.array([pick[ka](al, ra) for ka, _, ra, _ in words], np.int64)
    b = np.array([pick[kb](bl, rb) for _, kb, _, rb in words], np.int64)
    got = run_host(host["mul"], a, b, *long_division.mul_trunc_format(al, ai, bl, bi, nl, ni))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    consts = packed.mul_window_consts(al, ai, bl, bi, nl, ni, 1)
    np.testing.assert_array_equal(
        got, (packed.mul_window_sum(ta, tb, consts, 1) & ((1 << nl) - 1)).numpy())
    np.testing.assert_array_equal(
        got, packed.mul_trunc_packed(ta, al, ai, tb, bl, bi, nl, ni, 1).numpy())


# ---- routing ------------------------------------------------------------


@pytest.fixture
def spies(monkeypatch):
    """Record the wrapper calls, passing through to the wrappers."""
    calls = []
    for name in ("batched_long_division_float", "batched_long_division", "batched_mul_window"):
        fn = getattr(long_division, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[2:]))
            return _fn(*args)

        monkeypatch.setattr(long_division, name, spy)
    return calls


@pytest.fixture
def kernel_route(monkeypatch):
    """Route CPU tensors as CUDA tensors are routed, so that the choice of
    wrapper shows here; the wrappers then run their plain versions."""
    monkeypatch.setattr(packed, "_to_kernel", lambda t: not getattr(packed._PLAIN, "on", False))


def _division_qfloats(seed=0):
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randint(0, 1 << 40, size=64, dtype=np.int64))
    b = torch.from_numpy(rng.randint(0, 1 << 40, size=64, dtype=np.int64))
    b[:3] = 0
    return PackedQFloat(a, 40, 20), PackedQFloat(b, 40, 20)


def test_cpu_tensors_reach_no_kernel(spies):
    """A CPU tensor divides and multiplies through the plain versions; no
    wrapper is called and no kernel launches."""
    before = profiling.counters("launch.")
    a, b = _division_qfloats()
    a / b, b.invert(1, 40, 0), a * b
    for impl in (None, "classic"):
        with mt.set_division_impl(impl):
            a / b
    assert spies == [] and profiling.counters("launch.") == before


def test_division_routing(spies, kernel_route):
    """Divisions on the kernel route go to K2 with k from
    _float_div_chunk_bits, to K3 under set_division_impl("classic") or
    where k < 4, and to no wrapper inside plain_arithmetic(); all give the
    same bits."""
    before = profiling.counters("launch.")
    a, b = _division_qfloats()
    with packed.plain_arithmetic():
        ref_div, ref_inv = (a / b).mag, b.invert(1, 40, 0).mag
    assert spies == []
    assert torch.equal((a / b).mag, ref_div)
    assert torch.equal(b.invert(1, 40, 0).mag, ref_inv)
    with mt.set_division_impl("classic"):
        assert torch.equal((a / b).mag, ref_div)
        assert torch.equal(b.invert(1, 40, 0).mag, ref_inv)
    assert spies == [
        ("batched_long_division_float", (60, 15)),
        ("batched_long_division_float", (61, 15)),
        ("batched_long_division", (60, 1)),
        ("batched_long_division", (61, 1)),
    ]
    # a divisor too wide for the float form (k < 4) takes K3
    wide = PackedQFloat(torch.tensor([3, 0, 1]), 60, 59)
    q = wide.invert(1, 2, 0)
    assert spies[-1] == ("batched_long_division", (4, 1))
    assert q.mag.tolist() == [8 // 3, 3, 0]
    assert profiling.counters("launch.") == before


def test_switches_are_scoped_and_checked():
    """set_division_impl and plain_arithmetic() restore on exit, also on an
    error; plain_arithmetic() holds for its own thread only."""
    assert packed._DIVISION_IMPL is None
    with mt.set_division_impl("classic"):
        assert packed._DIVISION_IMPL == "classic"
    assert packed._DIVISION_IMPL is None
    mt.set_division_impl("classic")
    try:
        assert packed._DIVISION_IMPL == "classic"
    finally:
        mt.set_division_impl(None)
    for bad in ("fast", "float", True):
        with pytest.raises(ValueError):
            mt.set_division_impl(bad)
    seen = []
    with pytest.raises(RuntimeError):
        with packed.plain_arithmetic():
            with packed.plain_arithmetic():
                seen.append(packed._PLAIN.on)
            seen.append(packed._PLAIN.on)
            other = threading.Thread(target=lambda: seen.append(getattr(packed._PLAIN, "on", False)))
            other.start()
            other.join()
            raise RuntimeError
    assert seen == [True, True, False] and packed._PLAIN.on is False


def test_mul_routing(spies, kernel_route):
    """Untracked base-2 multiplies on the kernel route go to K4's wrapper,
    with the operands' formats; base 4, tracked and plain_arithmetic()
    multiplies keep the plain forms."""
    rng = np.random.RandomState(1)
    a2 = PackedQFloat(torch.from_numpy(rng.randint(0, 1 << 31, size=40, dtype=np.int64)), 31, 12)
    b2 = PackedQFloat(torch.from_numpy(rng.randint(0, 1 << 23, size=40, dtype=np.int64)), 23, 5)
    a4 = PackedQFloat(torch.from_numpy(rng.randint(0, 1 << 28, size=40, dtype=np.int64)), 14, 5, base=4)
    with packed.plain_arithmetic():
        ref2, ref4 = qf_from_mul(a2, b2, 27, 10).mag, (a4 * a4).mag
    assert spies == []
    assert torch.equal(qf_from_mul(a2, b2, 27, 10).mag, ref2)
    assert torch.equal((a4 * a4).mag, ref4)
    with track_overflow():
        assert torch.equal(qf_from_mul(a2, b2, 27, 10).mag, ref2)
    assert spies == [("batched_mul_window", (31, 12, 23, 5, 27, 10))]


def test_plain_version_reaches_no_wrapper(spies, kernel_route):
    """K1's plain version runs inside plain_arithmetic(): no wrapper is
    called, where the op-by-op path on the same route calls K2's and K4's."""
    mags = torch.from_numpy(np.random.RandomState(2).randint(0, 1 << 30, size=(6, 9)))
    signs = torch.ones(6, 9, dtype=torch.int64)
    args = (3, 40, 20, 2, True)
    ref = fused_inverse.fused_matrix_inverse_reference(mags, signs, *args)
    assert spies == [] and packed._PLAIN.on is False
    got = mt.qfloat_matrix_inverse_packed_io(mags, signs, *args, lowering="unroll")
    assert {name for name, _ in spies} == {"batched_long_division_float", "batched_mul_window"}
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_wrappers_check_inputs():
    v = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    d = torch.tensor([1, 2, 0])
    q = long_division.batched_long_division(v, d, 4, 1)
    assert q.shape == (2, 3) and q.tolist() == [[0, 0, 15], [3, 2, 15]]
    assert long_division.batched_long_division_float(torch.tensor(7), d, 8, 4).tolist() == [7, 3, 255]
    meta = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        long_division.batched_long_division(meta, meta, 4, 1)
    with pytest.raises(TypeError, match="int64"):
        long_division.batched_long_division(v.to(torch.int32), d, 4, 1)
    with pytest.raises(ValueError, match="k in"):
        long_division.batched_long_division_float(v, d, 60, 16)
    with pytest.raises(ValueError, match="bits"):
        long_division.batched_long_division(v, d, 40, 2)
    for bad in ((40, 41, 40, 20, 40, 20), (63, 20, 40, 20, 40, 20), (40, 20, 40, 20, 0, 0)):
        with pytest.raises(ValueError, match="len <= 62"):
            long_division.batched_mul_window(v, v, *bad)
    assert long_division.batched_mul_window(torch.tensor(3), v, 4, 2, 4, 2, 4, 2).tolist() == [
        [0, 0, 1], [1, 3, 3]]
