"""Robust inter-request scheduling — Algorithm 1 (Appendix B).

Combines the RED dispatch order (Step 1) with a worst-case feasibility check
(Step 2) and selective pruning with soft enforcement (Step 3) to defeat the
*Black Hole effect*: under overload, a batch may look urgent while carrying a
workload that cannot possibly meet its deadline; serving it starves viable
batches. The algorithm iteratively prunes the requests contributing the most
load to the bottleneck port until the remainder becomes feasible, demoting
pruned requests to a scavenger class rather than dropping them.

Latency estimation follows Appendix B Step 2: computation latency is treated
as deterministic (static transformer graph + offline profile — here the
analytic latency model in repro.simcluster.latency), and communication
latency is the cumulative load on the bottleneck port divided by its
bandwidth, under a worst-case no-overlap-between-batches assumption.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .red import red_score, partition_by_max_gap

__all__ = ["BatchLoad", "InterSchedule", "inter_request_schedule"]


@dataclass
class BatchLoad:
    """Scheduler view of one batch.

    ``request_loads`` maps request id -> load vector over the P network ports
    (bytes each request will push through each port, from the traffic
    matrix; for MoE this uses historical routing statistics — §B notes <=20%
    error is tolerable). ``compute_time`` is the batch's deterministic
    computation latency; ``deadlines`` maps request id -> absolute deadline.
    """

    bid: int
    request_loads: Dict[int, np.ndarray]
    deadlines: Dict[int, float]
    compute_time: float = 0.0

    def load_vector(self, members: Sequence[int]) -> np.ndarray:
        mats = [self.request_loads[r] for r in members]
        if not mats:
            first = next(iter(self.request_loads.values()))
            return np.zeros_like(first)
        return np.sum(mats, axis=0)

    @property
    def red(self) -> float:
        return red_score(list(self.deadlines.values()))

    @property
    def loose_min(self) -> float:
        tight, loose = partition_by_max_gap(list(self.deadlines.values()))
        return loose[0] if loose else tight[0]


@dataclass
class InterSchedule:
    """Output of Algorithm 1."""

    order: List[int]                       # sigma: batch ids by ascending RED
    pruned: List[Tuple[int, int]]          # H: (batch id, request id)
    finish_estimates: Dict[int, float] = field(default_factory=dict)
    red_scores: Dict[int, float] = field(default_factory=dict)


def _est_finish(now: float, S: np.ndarray, L: np.ndarray,
                compute_time: float, port_bw: np.ndarray) -> float:
    """Worst-case finish estimate (Appendix B Step 2).

    The worst-case assumption is *no overlap between batches*: interference S
    from every higher-priority batch is serialised onto the bottleneck port.
    Within a batch, communication normally overlaps computation, so the
    batch's own finish is bounded by the slower of its compute time and its
    bottleneck drain, not their sum.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        drain = np.where(port_bw > 0, (S + L) / port_bw, 0.0)
    comm = float(drain.max()) if drain.size else 0.0
    return now + max(compute_time, comm)


def inter_request_schedule(
    batches: Sequence[BatchLoad],
    port_bandwidth: np.ndarray,
    now: float = 0.0,
    drop_budget: int = 10**9,
) -> InterSchedule:
    """Algorithm 1: RED ordering + feasibility check + selective pruning.

    Triggered on batch arrival/departure (never per layer — §4.4.2 explicitly
    avoids fine-grained updates to keep the scheduler robust to transient
    load-estimation jitter).
    """
    port_bw = np.asarray(port_bandwidth, dtype=np.float64)
    S = np.zeros_like(port_bw)                    # interference from higher-priority batches
    pool: Dict[Tuple[int, int], np.ndarray] = {}  # candidate pool P: (bid, rid) -> load
    pruned: List[Tuple[int, int]] = []
    # Step 1 — global order by RED (ascending), bid as deterministic tiebreak.
    order = sorted(batches, key=lambda b: (b.red, b.bid))
    sched = InterSchedule(order=[b.bid for b in order], pruned=pruned)
    members: Dict[int, List[int]] = {b.bid: list(b.request_loads) for b in order}

    for b in order:
        sched.red_scores[b.bid] = b.red
        for r in members[b.bid]:
            pool[(b.bid, r)] = b.request_loads[r]
        L = b.load_vector(members[b.bid])
        fhat = _est_finish(now, S, L, b.compute_time, port_bw)
        # Step 2 — worst-case feasibility against the loose-min deadline.
        while fhat > b.loose_min and len(pruned) < drop_budget and pool:
            # Step 3 — prune the heaviest contributor on the bottleneck port.
            u_star = int(np.argmax(S + L))
            key = max(pool, key=lambda k: (pool[k][u_star], k))
            victim_bid, victim_rid = key
            load = pool.pop(key)
            pruned.append(key)
            members[victim_bid].remove(victim_rid)
            if victim_bid == b.bid:
                L = L - load          # drop from the current batch
            else:
                S = S - load          # drop from an already-admitted batch
            fhat = _est_finish(now, S, L, b.compute_time, port_bw)
        S = S + L
        sched.finish_estimates[b.bid] = fhat
    return sched
