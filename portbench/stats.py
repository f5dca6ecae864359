"""The benchmark's arithmetic on numbers it measured: percentiles, rates,
the union of busy intervals and its gaps."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of all ``values``, interpolated
    linearly between the order statistics around rank q/100 * (n - 1)
    (numpy's default; ``statistics.quantiles(method="inclusive")``)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = q / 100.0 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(completed: int, seconds: float) -> float:
    """Work completed over the seconds it took."""
    if seconds <= 0:
        raise ValueError("rate over a window of no time")
    return completed / seconds


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers, in order."""
    out = []
    at = lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out

