"""Arithmetic of the benchmark's numbers: rates, percentiles, spreads and
the device's busy time."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(completed: int, seconds: float) -> float:
    """Work completed over the seconds it took."""
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return completed / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q % of the values at or below it. A missing value
    (``math.inf``: a failed request) counts as slower than every other."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
