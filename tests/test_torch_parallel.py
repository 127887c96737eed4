"""Port vs JAX package: ``parallel/mesh.py``, the data-parallel API and the
multi-device drivers, on the CPU.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``); the
port's on its 8-entry CPU mesh (``make_mesh(device="cpu")``), each shard
through the plain versions.  Inputs are seeded numpy arrays; every
comparison is bit for bit, flags and the float32 statistic included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models.inverse import (
    qfloat_matrix_inverse_packed_io as jax_packed_io,
    qfloat_matrix_inverse_with_overflow as jax_with_overflow,
)
from matrix_inversion_tpu.parallel import mesh as jax_mesh
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops import fused_inverse
from matrix_inversion_tpu_torch.parallel import (
    Mesh,
    NamedSharding,
    P,
    ShardedProgram,
    cell_sharded_pipeline,
    data_parallel_inverse,
    data_parallel_inverse_fused,
    make_mesh,
    sharded_inverse_with_stats,
)
from matrix_inversion_tpu_torch.utils import run_benchmarks

torch.set_num_threads(2)


def digit_inputs(p, B, seed):
    M = np.random.RandomState(seed).randn(B, p.n, p.n) * 100
    return mt.float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)


def port(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def low3():
    """LOW n=3, B = 16: the digits, and JAX's data_parallel_inverse and
    sharded_inverse_with_stats on its 8-device mesh."""
    p = mt.LOW.replace(n=3)
    d, s = digit_inputs(p, 16, 0)
    jp = mi.LOW.replace(n=3)
    jm = jax_mesh.make_mesh(8)
    out = np.asarray(jax_mesh.data_parallel_inverse(jp, jm, "packed")(jnp.asarray(d),
                                                                      jnp.asarray(s)))
    sout, stat = jax_mesh.sharded_inverse_with_stats(jp, jm, "packed")(jnp.asarray(d),
                                                                       jnp.asarray(s))
    return p, d, s, out, np.asarray(sout), np.asarray(stat)


def test_data_parallel_inverse_matches_jax(low3):
    p, d, s, expected, _, _ = low3
    got = data_parallel_inverse(p, make_mesh(device="cpu"), "packed")(*port(d, s))
    assert got.dtype == torch.int32 and got.shape == (16, 9, p.qfloat_len + 1)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_sharded_inverse_with_stats_matches_jax(low3):
    p, d, s, _, expected, stat = low3
    out, got = sharded_inverse_with_stats(p, make_mesh(device="cpu"), "packed")(*port(d, s))
    np.testing.assert_array_equal(out.numpy(), expected)
    assert got.dtype == torch.float32 and got.shape == () and stat.dtype == np.float32
    assert got.item() == stat.item() > 0


def test_cell_sharded_pipeline_matches_data_parallel_and_jax():
    """On a (4, 2) ("data", "cell") mesh; JAX's own cell pipeline is a slow
    test there, so the port is held to JAX's cheaper data_parallel_inverse.
    Digits past the base are clipped in the cell stage, as in JAX."""
    p = mt.LOW.replace(n=4)
    d, s = digit_inputs(p, 8, 1)
    mesh = make_mesh(8, axis_names=("data", "cell"), shape=(4, 2), device="cpu")
    got = cell_sharded_pipeline(p, mesh, "packed")(*port(d, s))
    dp = data_parallel_inverse(p, make_mesh(device="cpu"), "packed")(*port(d, s))
    np.testing.assert_array_equal(got.numpy(), dp.numpy())
    expected = jax_mesh.data_parallel_inverse(mi.LOW.replace(n=4), jax_mesh.make_mesh(8),
                                              "packed")(jnp.asarray(d), jnp.asarray(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    wild = d.copy()
    wild[:, ::3, ::5] += 3  # out of range: the cell stage clips them to base - 1
    clipped = np.clip(wild, 0, p.qfloat_base - 1)
    np.testing.assert_array_equal(
        cell_sharded_pipeline(p, mesh, "packed")(*port(wild, s)).numpy(),
        data_parallel_inverse(p, make_mesh(device="cpu"), "packed")(*port(clipped, s)).numpy())


@pytest.mark.parametrize("n,B,seed", [(2, 16, 2), (3, 64, 3)])
def test_data_parallel_inverse_fused_matches_jax(n, B, seed):
    """Untracked and tracked against JAX's unrolled packed-I/O circuit:
    values, signs and flags; a near-singular matrix flags at n = 2, a
    singular one saturates at n = 3."""
    p = mt.LOW.replace(n=n)
    M = np.random.RandomState(seed).randn(B, n, n) * 100
    if n == 2:
        M[0, 1] = M[0, 0] * (1 + 1e-12)
    else:
        M[3] = 0.0
    mags, signs = float_matrix_to_mags_and_signs(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    args = (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    jargs = (jnp.asarray(mags), jnp.asarray(signs), *args)
    mesh = make_mesh(device="cpu")
    got = data_parallel_inverse_fused(p, mesh)(*port(mags, signs))
    for g, r in zip(got, jax_packed_io(*jargs, lowering="unroll")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    tracked = data_parallel_inverse_fused(p, mesh, track=True)(*port(mags, signs))
    ref = jax_with_overflow(*jargs, lowering="unroll")
    assert len(tracked) == 3 and tracked[2].dtype == torch.int32
    for g, r in zip(tracked, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if n == 2:
        assert tracked[2][0] == 1


def test_data_parallel_inverse_fused_needs_packed():
    with pytest.raises(ValueError, match="packed configuration"):
        data_parallel_inverse_fused(mt.LOW.replace(n=2, qfloat_base=10), make_mesh(device="cpu"))


def test_batched_api_data_parallel_matches_jax():
    p = mt.LOW.replace(n=2)
    M = np.random.RandomState(4).randn(16, 2, 2) * 100
    dp = mt.BatchedMatrixInversion(p, 16, backend="packed", io="packed", data_parallel=True,
                                   device="cpu")
    assert dp.mesh.shape == {"data": 8} and isinstance(dp._circuit, ShardedProgram)
    ref = JaxBatched(mi.LOW.replace(n=2), 16, backend="packed", io="packed",
                     data_parallel=True)
    np.testing.assert_array_equal(dp.run(M), ref.run(M))
    tracked = mt.BatchedMatrixInversion(p, 16, backend="packed", io="packed",
                                        data_parallel=True, track_overflow=True, device="cpu")
    one = mt.BatchedMatrixInversion(p, 16, backend="packed", io="packed", track_overflow=True,
                                    device="cpu")
    for g, r in zip(tracked.run(M), one.run(M)):
        np.testing.assert_array_equal(g, r)


def test_batched_api_data_parallel_validation_is_jax():
    p, jp = mt.LOW.replace(n=2), mi.LOW.replace(n=2)
    for make in (lambda **kw: mt.BatchedMatrixInversion(p, device="cpu", **kw),
                 lambda **kw: JaxBatched(jp, **kw)):
        with pytest.raises(ValueError, match="io='packed'"):
            make(batch_size=16, data_parallel=True)
        with pytest.raises(ValueError, match="divisible"):
            make(batch_size=13, backend="packed", io="packed", data_parallel=True)


def test_batched_api_auto_is_one_device_off_the_card():
    inv = mt.BatchedMatrixInversion(mt.LOW.replace(n=2), 16, backend="packed", io="packed",
                                    device="cpu")
    assert inv.mesh is None and not isinstance(inv._circuit, ShardedProgram)


def test_batched_api_keeps_the_named_card(monkeypatch):
    """With two cards visible (faked: nothing touches a card here),
    ``data_parallel=None`` stays on one card, the one the caller named;
    ``True`` takes every card on ``"cuda"`` and the named card alone on
    ``"cuda:1"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    p = mt.LOW.replace(n=2)

    def make(device, data_parallel):
        return mt.BatchedMatrixInversion(p, 16, backend="packed", io="packed", device=device,
                                         data_parallel=data_parallel)

    for device in ("cuda", "cuda:1"):
        auto = make(device, None)
        assert auto.mesh is None and auto.device == torch.device(device)
    named = make("cuda:1", True)
    assert list(named.mesh.devices.flat) == [torch.device("cuda", 1)]
    assert named.device == torch.device("cuda", 1)
    every = make("cuda", True)
    assert list(every.mesh.devices.flat) == [torch.device("cuda", i) for i in range(2)]
    assert every.device == torch.device("cuda", 0)


def test_data_parallel_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        mt.BatchedMatrixInversion(mt.LOW.replace(n=2), 16, backend="packed", io="packed",
                                  data_parallel=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh()


@pytest.mark.parametrize("spec,shape", [
    (P("data", None, None), (8,)),
    (P("data", "cell", None), (4, 2)),
    (P(None, "cell"), (4, 2)),
    (P(), (8,)),
])
def test_batched_api_shardings_equal_one_device(spec, shape):
    """Digit I/O through ``in_shardings`` (a tuple, one per input) and
    ``out_shardings``: the batch over ``data``, the cells over ``cell``
    (gathered first), or one device."""
    p = mt.LOW.replace(n=2)
    names = ("data", "cell")[:len(shape)]
    mesh = make_mesh(8, axis_names=names, shape=shape, device="cpu")
    M = np.random.RandomState(5).randn(8, 2, 2) * 100
    one = mt.BatchedMatrixInversion(p, 8, device="cpu").run(M)
    sharding = NamedSharding(mesh, spec)
    for kw in ({"in_shardings": (sharding, NamedSharding(mesh, P(*spec[:2])))},
               {"out_shardings": sharding}):
        inv = mt.BatchedMatrixInversion(p, 8, device="cpu", **kw)
        assert inv.mesh is mesh
        np.testing.assert_array_equal(inv.run(M), one)


def test_batched_api_rejects_other_shardings():
    mesh = make_mesh(8, axis_names=("data", "cell"), shape=(4, 2), device="cpu")
    for spec in (P("cell", None), P(None, "data"), P(None, None, "data")):
        with pytest.raises(ValueError, match="batch axis over 'data'"):
            mt.BatchedMatrixInversion(mt.LOW.replace(n=2), 8, device="cpu",
                                      in_shardings=NamedSharding(mesh, spec))
    with pytest.raises(ValueError, match="no 'cell' axis"):
        mt.BatchedMatrixInversion(mt.LOW.replace(n=2), 8, device="cpu",
                                  in_shardings=NamedSharding(make_mesh(device="cpu"),
                                                             P("data", "cell")))


def test_make_mesh_on_the_cpu():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 8} and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    grid = make_mesh(8, ("data", "cell"), (4, 2), device="cpu")
    assert grid.shape == {"data": 4, "cell": 2} and grid.devices.shape == (4, 2)
    assert make_mesh(3, ("data", "cell"), device="cpu").shape == {"data": 3, "cell": 1}
    with pytest.raises(ValueError, match="axis names"):
        Mesh(grid.devices, ("data",))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        make_mesh(device="meta")
    assert P("data", None) == ("data", None) and P() == ()


def test_sharded_program_splits_and_gathers():
    """Row blocks in order, each shard's output on its device, one shard's
    output returned as it is, an indivisible batch refused."""
    mesh = make_mesh(4, device="cpu")
    program = ShardedProgram(lambda a, b: (a * 2, b[:, :1]), mesh)
    a = torch.arange(24).reshape(8, 3)
    shards = program.shards(a, a + 1)
    assert len(shards) == 4 and all(s[0].shape == (2, 3) for s in shards)
    got = program.gather(shards)
    assert torch.equal(got[0], a * 2) and torch.equal(got[1], (a + 1)[:, :1])
    single = ShardedProgram(lambda x: x + 1, make_mesh(1, device="cpu"))
    out = single.shards(a)[0]
    assert single.gather([out]) is out
    with pytest.raises(ValueError, match=r"batch axis \(7\) does not divide over 4"):
        program(a[:7], a[:7])
    cells = ShardedProgram(lambda x: x, make_mesh(4, ("data", "cell"), (2, 2), device="cpu"),
                           cells=True, stage=lambda x: -x)
    assert torch.equal(cells(a[:, :2]), -a[:, :2])
    with pytest.raises(ValueError, match=r"cell axis \(3\) does not divide over 2"):
        cells(a)


def test_shardmap_check_on_the_cpu_mesh():
    got = run_benchmarks.shardmap_check(per_card=2, preset="low", n=2, cpu_rows=4,
                                        device="cpu")
    assert got["devices"] == 8 and got["batch"] == 16 and got["platform"] == "cpu"
    for variant in ("untracked", "tracked"):
        assert got[variant]["bit_exact_vs_unsharded_fused"]
        assert got[variant]["k1_launches"] == 0  # the CPU runs K1's plain version


def test_scaling_keys_on_the_cpu_mesh(capsys):
    got = run_benchmarks.scaling(per_card=1, sizes=(1, 2, 16), reps=1, repeats=1, device="cpu")
    assert got["devices_visible"] == 8 and got["platform"] == "cpu" and got["card"] is None
    assert [k for k in got if k.startswith("devices=")] == ["devices=1", "devices=2"]
    for k in (1, 2):
        entry = got[f"devices={k}"]
        assert entry["batch"] == k and entry["collectives"] == 0
        assert entry["bit_exact_vs_one_card_k1"] and entry["inversions_per_s"] > 0
    run_benchmarks.main(["--device", "cpu", "scaling", "--per-card", "1", "--sizes", "1",
                         "--reps", "1", "--repeats", "1"])
    assert '"devices=1"' in capsys.readouterr().out.strip().splitlines()[-1]


def test_scaling_raises_on_a_collective(monkeypatch):
    def with_nccl(events, labels, prefix="step:"):
        return {label: {"ncclDevKernel_AllReduce": 1} for label in labels}

    monkeypatch.setattr(run_benchmarks, "device_work_by_range", with_nccl)
    with pytest.raises(RuntimeError, match="1 collectives"):
        run_benchmarks.scaling(per_card=1, sizes=(1,), reps=1, repeats=1, device="cpu")


def test_drivers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: run_benchmarks.scaling(per_card=1),
                 lambda: run_benchmarks.shardmap_check(per_card=1)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def test_fused_shards_count_no_launch_on_the_cpu():
    """On CPU tensors each shard runs the plain version: K1's launch
    counters stay where they were."""
    before = (fused_inverse.LAUNCHES, fused_inverse.TRACKED_LAUNCHES)
    p = mt.LOW.replace(n=2)
    m, s = port(*float_matrix_to_mags_and_signs(np.eye(2)[None].repeat(8, 0), p.qfloat_len,
                                                p.qfloat_ints, p.qfloat_base))
    data_parallel_inverse_fused(p, make_mesh(device="cpu"), track=True)(m, s)
    assert (fused_inverse.LAUNCHES, fused_inverse.TRACKED_LAUNCHES) == before
