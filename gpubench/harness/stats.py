"""The arithmetic of the metrics: percentiles, rates, and the busy and idle
parts of a stretch of time."""

from __future__ import annotations

import math


def percentile(values, q):
    """The ``q``-th percentile of ``values``, interpolated linearly between
    the two nearest ranks (numpy's default); raises on no values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    rank = (len(xs) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def rate(count, seconds):
    """``count`` per second over ``seconds``."""
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def rate_of_calls(ends, per_call):
    """``per_call`` items for each call whose outputs were ready at ``ends``
    (s from the window's start, in order), per second of the time those
    calls took: from the window's start to the last of them.  With the call
    that ends past the window's close among ``ends``, that is all the work
    over all the time: no fraction of a long call is lost, and a stall that
    the close cuts lowers the rate.  No calls: 0."""
    if not ends:
        return 0.0
    return rate(len(ends) * per_call, ends[-1])


def slice_rates(ends, seconds, width=5.0):
    """The completions at times ``ends`` (s from the window's start) per
    second in each whole slice of ``width`` seconds of a window of
    ``seconds``, as shares of their mean: how steady a window ran."""
    counts = [0] * int(seconds // width)
    for t in ends:
        if 0 <= t < len(counts) * width:
            counts[int(t // width)] += 1
    mean = sum(counts) / len(counts) if counts else 0
    return [c / mean for c in counts] if mean else []


def merged(intervals, lo, hi):
    """``intervals`` ((start, end) pairs) clipped to ``[lo, hi]`` and merged
    where they overlap, in order."""
    out = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def busy(intervals, lo, hi):
    """The time of ``[lo, hi]`` that some interval covers."""
    return sum(end - start for start, end in merged(intervals, lo, hi))


def gaps(intervals, lo, hi):
    """The parts of ``[lo, hi]`` that no interval covers, as (start, end)."""
    out, at = [], lo
    for start, end in merged(intervals, lo, hi):
        if start > at:
            out.append((at, start))
        at = end
    if hi > at:
        out.append((at, hi))
    return out


def idle_share(intervals, lo, hi):
    """The share, in percent, of ``[lo, hi]`` that no interval covers."""
    if hi <= lo:
        raise ValueError("an empty stretch")
    return 100.0 * (1.0 - busy(intervals, lo, hi) / (hi - lo))
