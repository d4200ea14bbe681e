"""The metric arithmetic the readers share: a rate over a whole window, a
percentile over all steps, and the union of intervals on one timeline."""

from __future__ import annotations

import numpy as np


def rate(amounts, t_start: float, t_end: float) -> float:
    """All the work of a window over all its seconds."""
    return float(sum(amounts)) / (t_end - t_start)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value (numpy's linear
    interpolation between the two nearest ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union_of(intervals) -> list:
    """Disjoint, sorted intervals covering the same time as ``intervals``
    ((start, end) pairs; empty ones dropped)."""
    out = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(disjoint) -> float:
    return float(sum(b - a for a, b in disjoint))


def gaps(disjoint, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that the sorted disjoint intervals leave
    uncovered."""
    out, t = [], lo
    for a, b in disjoint:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]
