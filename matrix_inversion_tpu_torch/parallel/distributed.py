"""Multi-process initialization and batch-slicing helpers on
``torch.distributed``.

Port of ``matrix_inversion_tpu/parallel/distributed.py``.  One process per
host (or per card) joins a process group; each process inverts its own
slice of the global batch on its local mesh (``parallel/mesh.py``), and
collectives carry only the reductions of ``sharded_inverse_with_stats``
and the cell gather of ``cell_sharded_pipeline``.  With no configuration
the same program runs as one process.

Where the JAX package builds one global ``jax.Array`` over every process's
devices, PyTorch has no such array: each process holds its own tensors,
and :func:`global_batch_arrays` returns them with their offset in the
global batch.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, *,
                           backend=None):
    """Join (or no-op) a ``torch.distributed`` process group.

    The arguments default from torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``host:port``), ``WORLD_SIZE`` and ``RANK``.  With no
    address or a single process this is a no-op returning False, so the
    same program runs on one host or many; else it initializes the group
    over ``tcp://<address>`` and returns True.  ``backend`` defaults to NCCL
    where a card is visible and gloo where none is.  NCCL
    refuses two ranks on one card: processes that share a card pass
    ``backend="gloo"`` (gloo reduces CUDA tensors, and its gather goes
    through the host, ``parallel/mesh.py::_all_gather``).
    """
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("RANK", "-1") or -1)
    if not coordinator_address or num_processes <= 1:
        return False  # one process
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _process_count_and_index():
    """``(world size, rank)`` of the process group, ``(1, 0)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_local_slice(global_batch_size, mesh, axis="data"):
    """``(start, size)`` of this process's slice of the global batch axis.

    Raises if the global batch does not divide evenly across processes:
    flooring would drop the remainder matrices."""
    n_proc, pid = _process_count_and_index()
    if global_batch_size % n_proc != 0:
        raise ValueError(
            f"global batch size {global_batch_size} is not divisible by "
            f"the process count {n_proc}; pad the batch or choose a "
            f"divisible size (remainder would be silently dropped)"
        )
    per = global_batch_size // n_proc
    return pid * per, per


def global_batch_arrays(local_arrays, mesh, spec):
    """This process's slice of the global batch, put where the mesh's
    data-parallel programs take it: ``(tensor, offset)``, the slice as a
    tensor on the mesh's first device and its offset along the global batch
    axis (the rank times the slice's length).

    In the JAX package this assembles one global ``jax.Array`` laid out by
    ``spec`` over every process's devices; here each process keeps its own
    tensor, which the programs shard over its local mesh by ``spec``.  The
    sharded axes of ``spec`` must divide over the mesh."""
    x = torch.as_tensor(np.asarray(local_arrays))
    for dim, axis in enumerate(spec):
        if axis is not None and x.shape[dim] % mesh.shape[axis]:
            raise ValueError(f"axis {dim} ({x.shape[dim]}) does not divide over the mesh's "
                             f"{axis!r} axis ({mesh.shape[axis]})")
    _, pid = _process_count_and_index()
    return x.to(mesh.devices.flat[0]), pid * x.shape[0]
