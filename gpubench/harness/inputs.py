"""A cell's input floats, made from the seed on the device in one call."""

from __future__ import annotations

import torch


def float_pool(seed, pool, batch, n, sampler, device):
    """``pool`` batches of ``batch`` float64 ``n x n`` matrices drawn by the
    configuration's ``sampler`` (``{"kind": "normal", "mean", "std"}``) with
    a generator on ``device`` seeded by ``seed``; returned on the host.  The
    same seed on the same kind of device gives the same floats; every seed
    gives the same shapes."""
    if sampler["kind"] != "normal":
        raise ValueError(f"unknown sampler {sampler['kind']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    x = torch.randn((pool, batch, n, n), generator=gen, device=device, dtype=torch.float64)
    return x.mul_(sampler["std"]).add_(sampler["mean"]).cpu()
