"""The division kernels (K2, K3), the windowed-multiply kernel (K4) and
their routing, on the CPU.

``csrc/long_division.cu`` and ``csrc/mul_window.cu`` compile as host C++
when ``__CUDACC__`` is not defined: the same per-element functions, with a
loop in place of the launch.  Built here with g++ (``-ffp-contract=off``,
as K2's rounding argument needs), they are held with tolerance 0 against
Python-int floor division, against the JAX package's XLA float division,
and against its Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them; K4 also against the port's truncated
multiply.  The inputs sit on the floor boundaries where an unfixed f32
estimate would be off by one, at the divide and invert widths of every
preset, with zero divisors and the widest divisor the exactness argument
allows.
"""

import ctypes
import subprocess
import threading

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
    """One g++ build per source, both at once; the host launch functions."""
    root = tmp_path_factory.mktemp("division_host")
    procs = {}
    for name in ("long_division", "mul_window"):
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
    }
    for key in ("float", "classic"):
        fns[key].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    fns["mul"].argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.POINTER(long_division.MulWindowTable),
    ]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def run_host(fn, x, y, *args):
    x, y = np.ascontiguousarray(x, np.int64), np.ascontiguousarray(y, np.int64)
    out = np.empty_like(x)
    assert fn(x.ctypes.data, y.ctypes.data, out.ctypes.data, len(x), *args) == 0
    return out


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
    got_scalar = run_host(host["float"], np.full_like(ds, one), ds, n_bits, k)
    np.testing.assert_array_equal(got_scalar, ref_scalar)
    np.testing.assert_array_equal(
        long_division.batched_long_division_float(
            torch.tensor(one), torch.from_numpy(ds), n_bits, k).numpy(),
        ref_scalar,
    )


# (len, ints) of a and b and the output: tests/test_pallas.py:80-83 (there
# written (ints, len)), and asymmetric formats, so that a swap of the
# length and integer-digit arguments shows.
MUL_FORMATS = [
    ((40, 16), (40, 16), (40, 16)),
    ((40, 16), (40, 0), (40, 16)),
    ((23, 9), (23, 9), (23, 9)),
    ((23, 9), (23, 9), (21, 21)),
    ((31, 12), (23, 5), (27, 10)),
    ((43, 40), (43, 40), (40, 0)),
    ((62, 62), (62, 62), (62, 62)),
]


@pytest.mark.parametrize("a_fmt,b_fmt,out_fmt", MUL_FORMATS)
def test_mul_window_host_exact(host, a_fmt, b_fmt, out_fmt):
    """K4 == JAX's Pallas kernel in interpret mode == the port's truncated
    multiply, and the port's table == JAX's."""
    (al, ai), (bl, bi), (nl, ni) = a_fmt, b_fmt, out_fmt
    rng = np.random.RandomState(al + bl + nl)
    a = rng.randint(0, 1 << 62, size=500, dtype=np.int64) & ((1 << al) - 1)
    b = rng.randint(0, 1 << 62, size=500, dtype=np.int64) & ((1 << bl) - 1)
    a[:2], b[2:4] = 0, (1 << bl) - 1
    consts = packed.mul_window_consts(al, ai, bl, bi, nl, ni, 1)
    jax_consts = jax_packed._mul_window_consts(ai, al, bi, bl, nl, ni, 1)
    assert [tuple(map(int, row)) for row in zip(*jax_consts)] == consts
    got = run_host(host["mul"], a, b, ctypes.byref(long_division.mul_window_table(consts, nl)))
    ref = pk.batched_mul_window(jnp.asarray(a), jnp.asarray(b), jax_consts, nl, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    trunc = packed.mul_trunc_packed(torch.from_numpy(a), al, ai, torch.from_numpy(b), bl, bi, nl, ni, 1)
    np.testing.assert_array_equal(got, trunc.numpy())
    np.testing.assert_array_equal(
        long_division.batched_mul_window(torch.from_numpy(a), torch.from_numpy(b), consts, nl).numpy(),
        got,
    )


# ---- routing ------------------------------------------------------------


@pytest.fixture
def spies(monkeypatch):
    """Record the wrapper calls, passing through to the wrappers."""
    calls = []
    for name in ("batched_long_division_float", "batched_long_division", "batched_mul_window"):
        fn = getattr(long_division, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[2:] if "division" in _name else args[3:]))
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
    before = dict(long_division.LAUNCHES)
    a, b = _division_qfloats()
    a / b, b.invert(1, 40, 0), a * b
    for impl in (None, "classic"):
        with mt.set_division_impl(impl):
            a / b
    assert spies == [] and long_division.LAUNCHES == before


def test_division_routing(spies, kernel_route):
    """Divisions on the kernel route go to K2 with k from
    _float_div_chunk_bits, to K3 under set_division_impl("classic") or
    where k < 4, and to no wrapper inside plain_arithmetic(); all give the
    same bits."""
    before = dict(long_division.LAUNCHES)
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
    assert long_division.LAUNCHES == before


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
    with the port's table; base 4, tracked and plain_arithmetic()
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
    assert spies == [("batched_mul_window", (27,))]


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
