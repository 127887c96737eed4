"""Device meshes and the batch-sharded inversion programs.

Port of ``matrix_inversion_tpu/parallel/mesh.py``.  Batches of independent
inversions shard over the ``data`` axis; the ``cell`` axis shards the n*n
cells of each matrix during the cell-parallel stage of
:func:`cell_sharded_pipeline` and is gathered before the cell-coupled LU
stage.

PyTorch has no single-process multi-device ``DeviceMesh``
(``torch.distributed.device_mesh`` wants one rank per device), so
:class:`Mesh` is the port's own: a numpy object array of ``torch.device``
with axis names, local to the process.  A program over it
(:class:`ShardedProgram`) takes whole tensors on the mesh's first device,
cuts them into contiguous row blocks, moves each block to its device, runs
the circuit once per data shard from one host thread, on that device's
current stream, and gathers the outputs in batch order back onto the first
device.  The cross-device copies order themselves against both devices'
current streams, so nothing synchronizes the host.  Within a process there
are no collectives: the counterpart of the JAX programs' zero collectives.
Between processes (``parallel/distributed.py``) the statistics of
:func:`sharded_inverse_with_stats` are summed with ``dist.all_reduce`` and
the cells of :func:`cell_sharded_pipeline` gathered with
``dist.all_gather``.

The circuit is issued from one thread on purpose: the kernels' libraries
and ``ops/packed.py``'s constant words are loaded and filled at first use,
and ``track_overflow``, ``set_division_impl`` and ``plain_arithmetic`` are
process-global switches (``runtime/stream.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from ..config import QFloatParams
from ..models.inverse import qfloat_matrix_inverse
from ..ops.fused_inverse import fused_matrix_inverse

CPU_MESH_SIZE = 8  # the JAX tests' virtual CPU devices (tests/conftest.py)


class PartitionSpec(tuple):
    """Mesh axis names (or ``None``) per array axis, as JAX's
    ``PartitionSpec``: ``P("data", None)`` shards axis 0 over ``data``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


class Mesh:
    """Devices in a named grid: ``devices`` is an object array of
    ``torch.device`` with one axis per name of ``axis_names``."""

    def __init__(self, devices, axis_names):
        grid = np.array(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {grid.shape} needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        """``{axis name: size}``, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec`, as JAX's ``NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec


def make_mesh(n_devices=None, axis_names=("data",), shape=None, *, device="cuda"):
    """A :class:`Mesh` over ``n_devices`` devices (``mesh.py:30-42`` of the
    JAX package).

    On ``"cuda"`` the first ``n_devices`` visible cards (default: all);
    raises without a card.  On
    ``"cpu"``, which only a caller may name, ``n_devices`` entries of the one
    CPU device (default 8, as the JAX tests' virtual CPU devices), so that
    the sharding runs on a host.  ``shape`` reshapes the devices into a
    multi-axis mesh, e.g. ``shape=(4, 2), axis_names=("data", "cell")``.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh targets CUDA devices and none is available; '
                               'pass device="cpu" for a mesh on the host')
        visible = torch.cuda.device_count()
        n_devices = visible if n_devices is None else n_devices
        if not 1 <= n_devices <= visible:
            raise ValueError(f"asked for {n_devices} cards, {visible} visible")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    elif device.type == "cpu":
        n_devices = CPU_MESH_SIZE if n_devices is None else n_devices
        devices = [torch.device("cpu")] * n_devices
    else:
        raise ValueError(f"a mesh is made of CUDA or CPU devices, not {device}")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return Mesh(np.array(devices, dtype=object).reshape(shape), axis_names)


def _on(device):
    """``device`` made current for the calls in the scope (a CUDA device)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _group():
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def _all_gather(x, dim):
    """``x`` of every process joined along ``dim`` in rank order.  Gloo's
    ``all_gather`` takes no CUDA tensors: there the pieces go through the
    host."""
    host = x.device.type == "cuda" and dist.get_backend() == "gloo"
    local = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    joined = torch.cat(parts, dim)
    return joined.to(x.device) if host else joined


def _split(x, parts, dim, what):
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"the {what} axis ({size}) does not divide over {parts} devices")
    return x.split(size // parts, dim)


class ShardedProgram:
    """``fn`` once per data shard of ``mesh``, on that shard's device.

    ``batch=True`` cuts axis 0 of every input into one contiguous row block
    per index of the ``data`` axis; ``cells=True`` also cuts axis 1 over the
    ``cell`` axis, runs ``stage`` (if given, on the first input: the
    cell-parallel stage) on each cell shard's device and gathers the cells
    on the data shard's device (``torch.cat``; with ``processes=True`` and a
    process group up, the processes' cells too, ``dist.all_gather`` in rank
    order) before ``fn``.
    Other mesh axes replicate: their first device serves.  Inputs and
    outputs are whole tensors on the first device (``device``); the
    outputs of :meth:`shards` lie on their shards' devices, and
    :meth:`gather` joins them.  Every input's sharded axes must divide
    evenly.
    """

    def __init__(self, fn, mesh, batch=True, cells=False, stage=None, processes=False):
        names = mesh.axis_names
        for axis, wanted in (("data", batch), ("cell", cells)):
            if wanted and axis not in names:
                raise ValueError(f"the mesh has no {axis!r} axis: {names}")
        rows = mesh.shape["data"] if batch else 1
        cols = mesh.shape["cell"] if cells else 1
        self.grid = np.empty((rows, cols), dtype=object)  # (data shards, cell shards)
        for i in range(rows):
            for j in range(cols):
                at = {"data": i if batch else 0, "cell": j if cells else 0}
                self.grid[i, j] = mesh.devices[tuple(at.get(a, 0) for a in names)]
        self.device = self.grid[0, 0]
        self.fn, self.cells, self.stage, self.processes = fn, cells, stage, processes

    def _cells(self, i, args):
        """The inputs of data shard ``i`` with their cells cut over the cell
        axis, staged, and gathered on the shard's device."""
        device = self.grid[i, 0]
        joined = []
        for k, x in enumerate(args):
            pieces = []
            for piece, cell_device in zip(_split(x, len(self.grid[i]), 1, "cell"), self.grid[i]):
                piece = piece.to(cell_device, non_blocking=True)
                if k == 0 and self.stage is not None:
                    piece = self.stage(piece)
                pieces.append(piece.to(device, non_blocking=True))
            x = torch.cat(pieces, 1)
            joined.append(_all_gather(x, 1) if self.processes and _group() else x)
        return joined

    def shards(self, *args):
        """``fn``'s output of each data shard, on the shard's device.  Every
        shard's copy is queued before the first ``fn``: the copies run on
        the first device's stream, so a copy queued after the first shard's
        ``fn`` would wait for it."""
        rows = [_split(x, len(self.grid), 0, "batch") for x in args]
        shards = []
        for i in range(len(self.grid)):
            shard = [r[i] for r in rows]
            if self.cells:
                shards.append(self._cells(i, shard))
            else:
                shards.append([x.to(self.grid[i, 0], non_blocking=True) for x in shard])
        outs = []
        for shard, device in zip(shards, self.grid[:, 0]):
            with _on(device):
                outs.append(self.fn(*shard))
        return outs

    def gather(self, outs):
        """The shards' outputs (a tensor or a tuple each) joined along the
        batch axis on the first device; one shard's output as it is."""
        if len(outs) == 1:
            return outs[0]
        single = isinstance(outs[0], torch.Tensor)
        joined = []
        for parts in ([outs] if single else zip(*outs)):
            out = torch.empty((sum(p.shape[0] for p in parts),) + parts[0].shape[1:],
                              dtype=parts[0].dtype, device=self.device)
            start = 0
            for p in parts:
                out[start:start + p.shape[0]].copy_(p, non_blocking=True)
                start += p.shape[0]
            joined.append(out)
        return joined[0] if single else tuple(joined)

    def __call__(self, *args):
        return self.gather(self.shards(*args))


def _digit_circuit(params: QFloatParams, backend):
    """The digit-I/O inverse of ``params`` (``models/inverse.py``): on a
    card, pack -> K1 -> unpack for n <= 12, op by op beyond."""
    p = params
    return functools.partial(
        qfloat_matrix_inverse, n=p.n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base, true_division=p.true_division, tensorize=p.tensorize,
        backend=backend or p.resolve_backend(),
    )


def data_parallel_inverse(params: QFloatParams, mesh: Mesh, backend=None):
    """Batched digit-I/O inverse with the batch sharded over ``data``:
    ``(B, n*n, len)`` digits and ``(B, n*n)`` signs in, ``(B, n*n, len+1)``
    out, all on the mesh's first device.  Each shard runs
    ``qfloat_matrix_inverse`` on its device: on a card pack, K1 and unpack
    for n <= 12 and the op-by-op path (K2, K4) beyond; on the CPU the
    plain version.  No collectives."""
    return ShardedProgram(_digit_circuit(params, backend), mesh)


def data_parallel_inverse_fused(params: QFloatParams, mesh: Mesh, track=False):
    """Batch-sharded fused inversion, packed I/O: K1
    (``ops/fused_inverse.py``) once per data shard on its device, the
    counterpart of the JAX package's ``shard_map`` around its kernel.

    The callable takes ``(B, n*n)`` int64 magnitudes and signs on the
    mesh's first device and returns the same, and with ``track=True`` also
    the int32 ``(B,)`` overflow flags, bit for bit the one-device K1's.  On
    a CPU mesh each shard runs K1's plain version.  The JAX package's Mosaic
    knobs ``tile_rows`` and ``interpret`` have no counterpart."""
    p = params
    if p.resolve_backend() != "packed":
        raise ValueError("fused lowering requires a packed configuration")
    return ShardedProgram(functools.partial(
        fused_matrix_inverse, n=p.n, qfloat_len=p.qfloat_len, qfloat_ints=p.qfloat_ints,
        qfloat_base=p.qfloat_base, true_division=p.true_division, track=track), mesh)


def sharded_inverse_with_stats(params: QFloatParams, mesh: Mesh, backend=None):
    """:func:`data_parallel_inverse` plus the global mean digit mass:
    ``(out, total / count)``, where each shard's float32 ``sum(|out|)`` and
    row count are summed over the mesh and, with a process group up, over
    the processes (``dist.all_reduce``; each process passes its own slice
    of the batch).  The statistic is a float32 0-dim tensor on the mesh's
    first device; sums below 2**24 are exact in any order."""
    program = data_parallel_inverse(params, mesh, backend)

    def run(digits, signs):
        outs = program.shards(digits, signs)
        local = torch.stack([o.abs().to(torch.float32).sum().to(program.device) for o in outs])
        rows = torch.tensor(float(sum(o.shape[0] for o in outs)), dtype=torch.float32,
                            device=program.device)
        moments = torch.stack([local.sum(), rows])
        if _group():
            dist.all_reduce(moments)
        return program.gather(outs), moments[0] / moments[1]

    return run


def cell_sharded_pipeline(params: QFloatParams, mesh: Mesh, backend=None):
    """Two-stage program on a ``("data", "cell")`` mesh: each (data, cell)
    shard clips its digits to ``[0, base - 1]``, the cells are gathered on
    each data shard's device, then :func:`data_parallel_inverse`'s circuit
    runs on each data shard.  With a process group up, the processes split
    the cell axis (process r holds the r-th block of ``n*n / world`` cells
    of every matrix) and every process returns the whole output."""
    base = params.qfloat_base
    return ShardedProgram(_digit_circuit(params, backend), mesh, cells=True,
                          stage=lambda d: d.clamp(0, base - 1), processes=True)
