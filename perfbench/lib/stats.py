"""Percentiles, frozen here so that no later change of the program moves
them."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default method). Raises on no values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies_with_unserved(done: Iterable[Optional[float]],
                            due: Iterable[float], end: float) -> List[float]:
    """Latency of each request due before ``end``: ``done - due`` for a
    request served by ``end``, and ``end - due`` for one that was not
    (``done`` is None, or later than ``end``). A stall that leaves
    requests waiting past the window's end therefore still raises the
    tail."""
    out = []
    for d, t in zip(done, due):
        if t >= end:
            continue
        out.append((min(d, end) if d is not None else end) - t)
    return out
