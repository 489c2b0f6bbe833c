"""Order statistics of a window's samples.

A tail is taken over every sample of the window, never over medians of
chunks: one stall anywhere raises it.  The quartiles are Python's
``statistics.quantiles(values, n=4)``, the ones the bounds are set by.
"""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default).  Raises on an empty sample."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and the third quartile, as a share
    of the median."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med
