"""Rate and percentile arithmetic over a run's frames.

Every statistic here is taken over the whole measured window and every
frame in it: a rate is the frames whose receipt falls inside
``[t0, t1)`` over the window's length (not over the span from the first
frame to the last, which would hide a stall at either edge), and a
percentile ranks every such frame.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def in_window(t: float, t0: float, t1: float) -> bool:
    return t0 <= t < t1


def window_rate(times: Iterable[float], t0: float, t1: float) -> float:
    """Events per second inside ``[t0, t1)``."""
    if t1 <= t0:
        raise ValueError("empty window")
    return sum(1 for t in times if in_window(t, t0, t1)) / (t1 - t0)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it. None for no values."""
    if not values:
        return None
    if not 0 < q <= 100:
        raise ValueError("q must be in (0, 100]")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def union_length(intervals: Iterable[Sequence[float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((float(a), float(b)) for a, b in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Sequence[float]], t0: float,
         t1: float) -> List[List[float]]:
    """The ``[start, end]`` stretches of ``[t0, t1]`` no interval covers."""
    out: List[List[float]] = []
    cur = t0
    for s, e in sorted((float(a), float(b)) for a, b in intervals):
        if s > cur:
            out.append([cur, min(s, t1)])
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append([cur, t1])
    return [g for g in out if g[1] > g[0]]
