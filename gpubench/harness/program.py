"""The program under test, as the drivers reach it: matrix_inversion_tpu_torch's
public API, built from a configuration file."""

from __future__ import annotations

import torch

import matrix_inversion_tpu_torch  # noqa: F401  (a checkout without the program stops here)


def inverter(config, batch, io, device):
    """``BatchedMatrixInversion`` of the configuration at ``batch``; a
    configuration with ``"track_overflow": true`` gets the per-matrix
    overflow flags as a third output of ``run_raw``."""
    from matrix_inversion_tpu_torch.config import QFloatParams
    from matrix_inversion_tpu_torch.runtime.api import BatchedMatrixInversion

    params = QFloatParams(
        n=config["n"], qfloat_len=config["qfloat_len"], qfloat_ints=config["qfloat_ints"],
        qfloat_base=config["qfloat_base"], true_division=config["true_division"],
        backend=config["backend"], lowering=config["lowering"],
    )
    return BatchedMatrixInversion(params, batch, backend=config["backend"], io=io, device=device,
                                  track_overflow=config.get("track_overflow", False))


def streaming(inv, depth, finish_workers):
    from matrix_inversion_tpu_torch.runtime.stream import StreamingInverter

    return StreamingInverter(inv, depth=depth, finish_workers=finish_workers)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(out):
    """A ``run_raw`` output (a tensor or a tuple of them) on the host."""
    if isinstance(out, tuple):
        return tuple(o.cpu() for o in out)
    return out.cpu()


def host_quantize(inv, floats, out):
    """The host half of ``inv.quantize`` as ``StreamingInverter``'s producer
    calls it: ``floats`` written into the host tensors ``out``."""
    inv._host_quantize(floats, out=tuple(o.numpy() for o in out))


def host_dequantize(inv, host):
    """The host half of ``inv.dequantize`` as a finish worker of
    ``StreamingInverter`` calls it, on host tensors (a tuple in packed I/O)."""
    if isinstance(host, tuple):
        return inv._host_dequantize(tuple(h.numpy() for h in host))
    return inv._host_dequantize(host.numpy())
