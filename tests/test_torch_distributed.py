"""Port vs JAX package: ``parallel/distributed.py`` and two processes on
``torch.distributed`` (gloo) on localhost.

The port's form of ``tests/test_distributed.py``: two ranks run
``initialize_distributed`` -> ``host_local_slice`` -> ``global_batch_arrays``
-> ``data_parallel_inverse`` on their halves of LOW n=3, B = 16, each on a
4-entry CPU mesh, and their joined outputs must equal JAX's one-process
``qfloat_matrix_inverse`` bit for bit.  The same ranks sum the statistic of
``sharded_inverse_with_stats`` across processes (``all_reduce``) and gather
the cells of ``cell_sharded_pipeline`` across them (``all_gather``), while
the API's cell sharding, with the group up, keeps to its process.  The
worker is this file's ``__main__`` block:

    python tests/test_torch_distributed.py <rank> <world> <port> <outdir>
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _matrices(n, seed):
    return np.random.RandomState(seed).randn(B, n, n) * 100


def worker(rank, world, port, outdir):
    """One rank: its half of the batch through the data-parallel program,
    the statistic over both ranks, and its block of cells through the
    cell pipeline."""
    import torch

    import matrix_inversion_tpu_torch as mt
    from matrix_inversion_tpu_torch.parallel import (
        NamedSharding,
        P,
        cell_sharded_pipeline,
        data_parallel_inverse,
        global_batch_arrays,
        host_local_slice,
        initialize_distributed,
        make_mesh,
        sharded_inverse_with_stats,
    )

    torch.set_num_threads(1)
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    assert torch.distributed.get_backend() == "gloo"
    p = mt.LOW.replace(n=3)
    digits, signs = mt.float_matrix_to_qfloat_arrays(_matrices(3, 0), p.qfloat_len,
                                                     p.qfloat_ints, p.qfloat_base)
    mesh = make_mesh(4, device="cpu")
    start, size = host_local_slice(B, mesh)
    d, offset = global_batch_arrays(digits[start:start + size], mesh, P("data", None, None))
    s, _ = global_batch_arrays(signs[start:start + size], mesh, P("data", None))
    assert offset == start and d.shape == (size, 9, p.qfloat_len)
    out = data_parallel_inverse(p, mesh, "packed")(d, s)
    stats_out, stat = sharded_inverse_with_stats(p, mesh, "packed")(d, s)
    assert torch.equal(stats_out, out)

    # the cell pipeline: this rank holds its block of the n*n cells of every matrix
    p2 = mt.LOW.replace(n=2)
    digits2, signs2 = mt.float_matrix_to_qfloat_arrays(_matrices(2, 1), p2.qfloat_len,
                                                       p2.qfloat_ints, p2.qfloat_base)
    per = 4 // world
    cells = slice(rank * per, (rank + 1) * per)
    grid = make_mesh(8, ("data", "cell"), (4, 2), device="cpu")
    cell_out = cell_sharded_pipeline(p2, grid, "packed")(
        torch.from_numpy(digits2[:, cells]), torch.from_numpy(signs2[:, cells]))
    # the API's cell sharding stays within the process, group or no group:
    # it takes every cell of the whole batch
    api = mt.BatchedMatrixInversion(p2, B, backend="packed", device="cpu",
                                    in_shardings=NamedSharding(grid, P("data", "cell", None)))
    api_out = api.run_raw(torch.from_numpy(digits2), torch.from_numpy(signs2))

    np.savez(os.path.join(outdir, f"out_{rank}.npz"), out=out.numpy(), cells=cell_out.numpy(),
             api=api_out.numpy())
    with open(os.path.join(outdir, f"meta_{rank}.json"), "w") as fh:
        json.dump({"start": start, "size": size, "offset": offset, "stat": stat.item(),
                   "ok": True}, fh)
    torch.distributed.destroy_process_group()
    print(f"worker {rank}: ok", flush=True)


def test_two_process_gloo_matches_jax(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), "2",
                               str(port), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"worker {rank} failed:\n{out}"

    metas = [json.load(open(tmp_path / f"meta_{rank}.json")) for rank in range(2)]
    assert [(m["start"], m["size"], m["offset"]) for m in metas] == [(0, 8, 0), (8, 8, 8)]
    results = [np.load(tmp_path / f"out_{rank}.npz") for rank in range(2)]
    got = np.concatenate([r["out"] for r in results])

    import jax
    import jax.numpy as jnp

    from matrix_inversion_tpu import LOW
    from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse
    from matrix_inversion_tpu.models.marshal import float_matrix_to_qfloat_arrays

    def jax_inverse(n, seed):
        p = LOW.replace(n=n)
        digits, signs = float_matrix_to_qfloat_arrays(_matrices(n, seed), p.qfloat_len,
                                                      p.qfloat_ints, p.qfloat_base)
        return np.asarray(jax.jit(lambda d, s: qfloat_matrix_inverse(
            d, s, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division,
            backend="packed"))(jnp.asarray(digits), jnp.asarray(signs)))

    expected = jax_inverse(3, 0)
    np.testing.assert_array_equal(got, expected)
    # the statistic: float32 sums below 2**24 are exact, so JAX's psum'd
    # value is the float32 total over the float32 count
    stat = np.float32(np.abs(expected).astype(np.float32).sum()) / np.float32(B)
    assert metas[0]["stat"] == metas[1]["stat"] == float(stat)
    cells = jax_inverse(2, 1)
    for r in results:
        np.testing.assert_array_equal(r["cells"], cells)
        np.testing.assert_array_equal(r["api"], cells)


def test_host_local_slice_rejects_indivisible(monkeypatch):
    """As ``tests/test_distributed.py``'s: one process takes the whole batch;
    with the group's size and rank faked to 3 and 1 an indivisible batch
    raises rather than drop its remainder."""
    import torch.distributed as dist

    from matrix_inversion_tpu_torch.parallel import host_local_slice, make_mesh

    mesh = make_mesh(4, device="cpu")
    assert host_local_slice(16, mesh) == (0, 16)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    with pytest.raises(ValueError, match="not divisible"):
        host_local_slice(16, mesh)
    assert host_local_slice(15, mesh) == (5, 5)


def test_initialize_distributed_is_a_no_op_for_one_process(monkeypatch):
    from matrix_inversion_tpu_torch.parallel import initialize_distributed

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed("127.0.0.1:1", 1, 0) is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed() is False


def test_global_batch_arrays_keeps_the_slice_and_its_offset(monkeypatch):
    import torch
    import torch.distributed as dist

    from matrix_inversion_tpu_torch.parallel import P, global_batch_arrays, make_mesh

    mesh = make_mesh(4, device="cpu")
    local = np.arange(8 * 3, dtype=np.int64).reshape(8, 3)
    x, offset = global_batch_arrays(local, mesh, P("data", None))
    assert offset == 0 and x.dtype == torch.int64 and np.array_equal(x.numpy(), local)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert global_batch_arrays(local, mesh, P("data"))[1] == 8
    with pytest.raises(ValueError, match="does not divide"):
        global_batch_arrays(local[:6], mesh, P("data", None))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
