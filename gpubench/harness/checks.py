"""The comparison that decides ``correct``: each sampled answer of the window
against the reference's, cell by cell, and in a configuration that tracks
overflow (``"track_overflow": true``) matrix by matrix for the flags.

A cell of an answer is one entry of the inverse: its magnitude and sign
(packed I/O), its digits and sign (digit I/O) or its float (floats out).
A tracked answer is ``(magnitudes, signs, flags)``, the flags one int32 a
matrix.  The comparison is exact: a cell that differs in any bit of its
encoding, or in its value, counts, and so does a matrix whose flag differs.
"""

from __future__ import annotations

import numpy as np
import torch

#: every number compared, with its limit: exact, so no cell and no flag may
#: differ; ``mismatched_flags`` is compared in a tracked configuration only
LIMITS = {"mismatched_cells": 0, "mismatched_flags": 0}


def mismatched_cells(got, want, io):
    """``(cells that differ, cells compared)`` of one answer; an answer of
    another shape or type than the reference's differs in every cell.  Of a
    tracked answer (``want`` has three parts) the magnitudes and signs are
    compared here, the flags by :func:`mismatched_flags`."""
    if io not in ("packed", "digits", "floats"):
        raise ValueError(f"unknown io {io!r}")
    want_parts = list(want) if io == "packed" else [want]
    cells = want_parts[0].shape[:-1].numel() if io == "digits" else want_parts[0].numel()
    if io == "floats" and not isinstance(got, torch.Tensor):
        got = torch.from_numpy(np.asarray(got))
    got_parts = list(got) if io == "packed" and isinstance(got, tuple) else [got]
    if len(want_parts) == 3:
        want_parts, got_parts = want_parts[:2], got_parts[:2]
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


def answer_flags(got, want):
    """The flags of a tracked answer, or None where it has no third part of
    the shape and type of the reference's flags (``want[2]``)."""
    mine = got[2] if isinstance(got, tuple) and len(got) == 3 else None
    if isinstance(mine, torch.Tensor) and mine.shape == want[2].shape \
            and mine.dtype == want[2].dtype:
        return mine
    return None


def mismatched_flags(got, want):
    """``(matrices whose flag differs, matrices compared)`` of one tracked
    answer against the reference's ``(magnitudes, signs, flags)``; an answer
    without such flags (:func:`answer_flags`) differs in every matrix."""
    mine, flags = answer_flags(got, want), want[2]
    if mine is None:
        return flags.numel(), flags.numel()
    return int((mine != flags).sum()), flags.numel()


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
