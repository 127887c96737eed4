"""The comparison that decides ``correct``: each sampled answer of the window
against the reference's, cell by cell.

A cell of an answer is one entry of the inverse: its magnitude and sign
(packed I/O), its digits and sign (digit I/O) or its float (floats out).
The comparison is exact: a cell that differs in any bit of its encoding, or
in its value, counts.
"""

from __future__ import annotations

import numpy as np
import torch

#: every number compared, with its limit: exact, so no cell may differ
LIMITS = {"mismatched_cells": 0}


def mismatched_cells(got, want, io):
    """``(cells that differ, cells compared)`` of one answer; an answer of
    another shape or type than the reference's differs in every cell."""
    if io not in ("packed", "digits", "floats"):
        raise ValueError(f"unknown io {io!r}")
    want_parts = list(want) if io == "packed" else [want]
    cells = want_parts[0].shape[:-1].numel() if io == "digits" else want_parts[0].numel()
    if io == "floats" and not isinstance(got, torch.Tensor):
        got = torch.from_numpy(np.asarray(got))
    got_parts = list(got) if io == "packed" and isinstance(got, tuple) else [got]
    if len(got_parts) != len(want_parts) or any(
            not isinstance(g, torch.Tensor) or g.shape != w.shape or g.dtype != w.dtype
            for g, w in zip(got_parts, want_parts)):
        return cells, cells
    pairs = list(zip(got_parts, want_parts))
    bad = pairs[0][0] != pairs[0][1]
    for g, w in pairs[1:]:
        bad |= g != w
    if io == "digits":
        bad = bad.any(-1)
    return int(bad.sum()), bad.numel()


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream of unknown
    length, drawn from ``seed`` (Algorithm R)."""

    def __init__(self, size, seed):
        import random

        self.size, self.seen, self.items = size, 0, []
        self._rng = random.Random(seed)

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1
