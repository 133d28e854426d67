"""Statistics of the measured window: percentiles, rate, and the run-to-run
spread by which the bounds are set."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work completed per second of the window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def spread(values) -> float:
    """(Q3 - Q1) / median by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def spread_trimmed(values) -> float:
    """The spread, leaving out the value farthest from the median where
    that narrows it (the rule a bound's tightness is judged by)."""
    full = spread(values)
    if len(values) < 4:
        return full
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return min(full, spread([v for i, v in enumerate(values) if i != far]))
