"""The issue-rate probes (K5) on the CPU.

``csrc/ubench.cu`` compiles as host C++ when ``__CUDACC__`` is not
defined: the same per-element chains, with a loop in place of the launch.
For each of the nine mixes of the JAX module the same numpy-seeded inputs
go through (a) the Pallas kernel, built here from the reference's own
``benchmarks/ubench_vpu.py::_make_kernel`` and run in interpret mode,
(b) the port's plain version ``ubench_reference`` and (c) the g++ host
build; all three agree bit for bit (tolerance 0; ``f32_mul`` too, except
that against the Pallas kernel its sum over several chains is held to one
float32 ulp, because XLA's CPU backend may fuse that sum with a multiply).
The four
cell mixes, which the JAX module does not have, are held to the same
recurrences written on ``PackedQFloat`` ops.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benchmarks import ubench_vpu  # noqa: E402

from matrix_inversion_tpu_torch.ops.cuda_build import CSRC  # noqa: E402
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat, track_overflow  # noqa: E402
from matrix_inversion_tpu_torch.utils import profiling, ubench  # noqa: E402

torch.set_num_threads(2)

JAX_MIXES = list(ubench_vpu.MIXES)
CELL_MIXES = [name for name in ubench.MIXES if name not in ubench_vpu.MIXES]
KC = [(1, 1), (3, 2), (17, 8)]
# a cell chain's XOR over chains cancels where the chains meet, so the cell
# mixes are also held at C = 1
CELL_KC = KC + [(3, 1), (17, 1)]
SHAPE = (8, 128)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The g++ build of ``csrc/ubench.cu``; returns its host launch."""
    lib = tmp_path_factory.mktemp("ubench_host") / "ubench.so"
    proc = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         "-x", "c++", "-I", str(CSRC), "-o", str(lib), str(CSRC / "ubench.cu")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"g++ failed for ubench.cu:\n{proc.stderr}"
    fn = ctypes.CDLL(str(lib)).ubench_chain_host
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int,
    ]
    fn.restype = ctypes.c_int
    return fn


def run_host(fn, name, x, y, K, C):
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    out = np.empty_like(x)
    rc = fn(ubench.MIXES[name][0], C, x.ctypes.data, y.ctypes.data, out.ctypes.data, x.size, K)
    assert rc == 0
    return out


def run_pallas(name, x, y, K, C):
    it, dtype = ubench_vpu.MIXES[name]
    call = pl.pallas_call(
        ubench_vpu._make_kernel(it, K, C, dtype),
        out_shape=jax.ShapeDtypeStruct(x.shape, dtype),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(x), jnp.asarray(y)))


def inputs(name, seed):
    x, y = ubench.make_inputs(name, SHAPE[0], "cpu", seed=seed)
    return x.numpy(), y.numpy()


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def test_mix_tables_agree():
    """The nine JAX mixes in the JAX order, then the four cell mixes; the
    indices are those of ``csrc/ubench.cu``'s enum."""
    assert list(ubench.MIXES)[:9] == JAX_MIXES
    assert CELL_MIXES == ["cell_mul", "cell_sadd", "cell_mul_window_t", "cell_divide"]
    assert [v[0] for v in ubench.MIXES.values()] == list(range(13))
    source = (CSRC / "ubench.cu").read_text()
    enum = source.split("enum Mix {")[1].split("}")[0]
    assert [e.strip().split(" ")[0].lower() for e in enum.split(",") if e.strip()] == list(
        ubench.MIXES)


@pytest.mark.parametrize("name", JAX_MIXES)
def test_nominal_ops_match_jax(name):
    it, dtype = ubench_vpu.MIXES[name]
    one = jnp.ones((1, 1), dtype)
    assert it(one, one)[2] == ubench.MIXES[name][2]
    assert {jnp.uint32: torch.uint32, jnp.float32: torch.float32}[dtype] == ubench.MIXES[name][1]


@pytest.mark.parametrize("K,C", KC, ids=[f"K{k}_C{c}" for k, c in KC])
@pytest.mark.parametrize("name", JAX_MIXES)
def test_pallas_reference_and_host_agree(host, name, K, C):
    """Pallas (interpret) == plain PyTorch version == g++ host build."""
    x, y = inputs(name, seed=11 + K)
    want = run_pallas(name, x, y, K, C)
    ref = ubench.ubench_reference(name, torch.from_numpy(x), torch.from_numpy(y), K, C).numpy()
    got = run_host(host, name, x, y, K, C)
    assert same_bits(got, ref), f"{name}: host build differs from the plain version"
    if name == "f32_mul" and C > 1:
        # XLA's CPU backend may contract a chain's last multiply with the sum
        # over chains into one fused multiply-add, which rounds once where the
        # port (and the TPU kernel) round twice: within one float32 ulp.
        np.testing.assert_allclose(ref, want, rtol=2.0 ** -23, atol=0)
    else:
        assert same_bits(ref, want), f"{name}: plain version differs from the Pallas kernel"
    if K == 1:
        assert len(np.unique(want)) > want.size // 2  # not a collapsed chain


@pytest.mark.parametrize("K", [2, 3, 5])
def test_f32_mul_single_chain_matches_pallas_exactly(host, K):
    """With one chain there is no sum to contract: tolerance 0."""
    x, y = inputs("f32_mul", seed=31 + K)
    want = run_pallas("f32_mul", x, y, K, 1)
    assert np.isfinite(want).all() and len(np.unique(want)) > want.size // 2
    ref = ubench.ubench_reference("f32_mul", torch.from_numpy(x), torch.from_numpy(y), K, 1)
    assert same_bits(ref.numpy(), want)
    assert same_bits(run_host(host, "f32_mul", x, y, K, 1), want)


def packed_recurrence(name, x, y, K):
    """One chain of a cell mix written on PackedQFloat operators."""
    mask, top = (1 << 40) - 1, 1 << 39
    one = torch.ones_like(x)
    a, b = PackedQFloat(x, 40, 20, 2, sign=one), PackedQFloat(y, 40, 20, 2, sign=one)
    flag = torch.zeros_like(x)
    for _ in range(K):
        if name == "cell_mul":
            a *= b
            b *= a
        elif name == "cell_sadd":
            a += -b
            b += a
        elif name == "cell_mul_window_t":
            with track_overflow() as tracker:
                a *= b
                b *= a
            flag = flag | tracker.combined(x.shape)
        elif name == "cell_divide":
            a = PackedQFloat(a.mag | top, 40, 20, 2) / PackedQFloat(b.mag | 1, 40, 20, 2)
            b = PackedQFloat(b.mag | top, 40, 20, 2) / PackedQFloat(a.mag | 1, 40, 20, 2)
    assert int(a.mag.max()) <= mask
    return a.mag ^ (flag.to(torch.int64) << 40)


@pytest.mark.parametrize("K,C", CELL_KC, ids=[f"K{k}_C{c}" for k, c in CELL_KC])
@pytest.mark.parametrize("name", CELL_MIXES)
def test_cell_mixes_agree(host, name, K, C):
    """Plain version == g++ host build == the recurrence on PackedQFloat."""
    x, y = inputs(name, seed=23 + K)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ref = ubench.ubench_reference(name, tx, ty, K, C).numpy()
    got = run_host(host, name, x, y, K, C)
    assert same_bits(got, ref), f"{name}: host build differs from the plain version"
    want = torch.zeros_like(tx)
    for c in range(C):
        want ^= packed_recurrence(name, (tx + (c + 1)) & ((1 << 40) - 1),
                                  (ty + (c + 1)) & ((1 << 40) - 1), K)
    assert same_bits(ref, want.numpy()), f"{name}: plain version differs from PackedQFloat"
    if C == 1:
        assert len(np.unique(ref)) > ref.size // 2  # not a collapsed chain


def test_cell_divide_keeps_the_long_path(host):
    """Every dividend of ``cell_divide`` is 60 bits wide after its shift:
    the chain never reaches operands that both fit 32 bits."""
    x, y = inputs("cell_divide", seed=5)
    for K in (1, 2, 9, 40):
        out = run_host(host, "cell_divide", x, y, K, 1)
        assert ((out | (1 << 39)) << 20 >= 1 << 59).all() and (out < (1 << 40)).all()


def test_tracked_multiply_flag_reaches_the_output(host):
    """``cell_mul_window_t`` puts the OR of its flags at bit 40."""
    x = np.full(SHAPE, (1 << 40) - 2, np.int64)  # the chain starts at x + 1
    out = run_host(host, "cell_mul_window_t", x, x, 1, 1)
    assert (out >> 40 == 1).all()
    small = np.full(SHAPE, (1 << 20) - 1, np.int64)  # starts at 1.0 x 1.0: no carry out
    assert (run_host(host, "cell_mul_window_t", small, small, 1, 1) == 1 << 20).all()


@pytest.mark.parametrize("name", list(ubench.MIXES))
def test_chain_refuses_cpu_tensors(name):
    """No quiet fallback: the wrapper measures the card or raises."""
    x, y = ubench.make_inputs(name, 2, "cpu")
    before = profiling.counters("launch.")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ubench.ubench_chain(name, x, y, 4, 1)
    assert profiling.counters("launch.") == before


def test_argument_checks():
    x, y = ubench.make_inputs("u32_add", 2, "cpu")
    with pytest.raises(ValueError, match="unknown mix"):
        ubench.ubench_reference("u32_sub", x, y, 1, 1)
    with pytest.raises(ValueError, match="C must be"):
        ubench.ubench_reference("u32_add", x, y, 1, 3)
    with pytest.raises(ValueError, match="C must be"):  # C = 2: the host build only
        ubench.ubench_chain("u32_add", x, y, 1, 2)
    with pytest.raises(TypeError, match="takes"):
        ubench.ubench_reference("f32_mul", x, y, 1, 1)
    with pytest.raises(ValueError, match="one shape"):
        ubench.ubench_reference("u32_add", x, y[:1], 1, 1)


def test_resident_warps():
    assert ubench.resident_warps(32) == 64
    assert ubench.resident_warps(40) == 48
    assert ubench.resident_warps(128) == 16
    assert ubench.resident_warps(255) == 8


def test_main_needs_a_card(capsys):
    assert ubench.main(["u32_add"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
