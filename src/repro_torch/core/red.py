"""Robust Effective Deadline (RED) — §4.4.2 / Appendix B Step 1.

Synchronous batch execution lets a single outlier hijack the urgency of the
whole batch (the *Piggyback effect*): one extremely tight request would pull
every batched peer to the front of the cluster-wide order. RED counteracts
this by splitting the batch into a *tight* and a *loose* sub-batch at the
**maximal deadline gap** and blending their minima, weighted by the tight
fraction f:

    RED(B) = f * D_min^Tight + (1 - f) * D_min^Loose

When tight requests are rare (small f) the score shifts toward the loose
deadline, so isolated outliers cannot dominate; when most of the batch is
tight (f -> 1) RED converges to plain EDF on the batch minimum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

__all__ = ["red_score", "partition_by_max_gap", "sort_by_red"]


def partition_by_max_gap(deadlines: Sequence[float]) -> Tuple[List[float], List[float]]:
    """Split sorted deadlines into (tight, loose) at the largest gap.

    Returns ``(tight, loose)`` where every tight deadline precedes every loose
    one. A batch of size 1 (or with all-equal deadlines) is all-tight with an
    empty loose set.
    """
    ds = sorted(float(d) for d in deadlines)
    n = len(ds)
    if n == 0:
        raise ValueError("empty batch")
    if n == 1:
        return ds, []
    gaps = [ds[k + 1] - ds[k] for k in range(n - 1)]
    k_star = max(range(n - 1), key=lambda k: gaps[k])
    if gaps[k_star] <= 0.0:
        return ds, []
    return ds[: k_star + 1], ds[k_star + 1:]


def red_score(deadlines: Sequence[float]) -> float:
    """RED of a batch of request deadlines (absolute times)."""
    tight, loose = partition_by_max_gap(deadlines)
    n = len(tight) + len(loose)
    if not loose:
        return tight[0]
    f = len(tight) / n
    return f * tight[0] + (1.0 - f) * loose[0]


@dataclass(frozen=True)
class BatchRef:
    """Minimal view of a batch the inter-request scheduler needs."""

    bid: int
    deadlines: Tuple[float, ...]

    @property
    def red(self) -> float:
        return red_score(self.deadlines)

    @property
    def loose_min(self) -> float:
        """D_min^Lo — the feasibility target of Algorithm 1 (tightest loose
        deadline; falls back to the batch minimum when all-tight)."""
        tight, loose = partition_by_max_gap(self.deadlines)
        return loose[0] if loose else tight[0]


def sort_by_red(batches: Sequence[BatchRef]) -> List[BatchRef]:
    """Global dispatch order: ascending RED, batch id as deterministic tie."""
    return sorted(batches, key=lambda b: (b.red, b.bid))
