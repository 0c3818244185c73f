"""Urgency metrics — MLU (§4.3) and RLI (§4.4.1).

MLU — Minimal Link Utilization — is the urgency metric for flows carrying an
explicit deadline (Stage 3 / P2D):

    MLU_i(t) = Size_rem(t) / (Time_rem(t) * B * (1 - rho))

i.e. the minimal share of the residual bottleneck capacity the flow must
receive from now on to finish by its deadline. MLU > 1 is infeasible; values
near 1 demand (near-)exclusive service; small values signal ample laxity and
justify deferral.

The continuous MLU is quantised onto K discrete priority levels via a
*geometric* threshold ladder, which minimises the worst-case relative
quantisation error |v - tau_k| / v (the optimal spacing is geometric because
the product of adjacent ratios is fixed at U_max/U_min — §4.3). Since U_max
and U_min are unknown online, the paper parameterises the ladder as

    Q_i = E^(-i) * U      (1 <= i <= K-1),   E = 4, U = 0.5 by default.

Level semantics used throughout this repo: level 1 is the *highest* physical
priority, level K the lowest; level K+1 is the scavenger class used by
overload control (Appendix B). Level assignment for an explicit-deadline flow:

    level(MLU) = 1                      if MLU >= U        (critical)
               = 1 + i  for smallest i  if MLU >= Q_i      (geometric band)
               = K                      otherwise           (ample laxity)

RLI — Relative Layer Index — is the urgency proxy for implicit-deadline flows
(Stages 1 & 2):   RLI = L_target - L_curr.  RLI = 0 means the flow blocks the
computation that is ready to run *now*; larger RLI = wider safe deferral
window. Theorem 1: smallest-RLI-first minimises prefill makespan under the
fluid model. Implicit flows map to levels 2..K (level 1 is reserved for
critical explicit-deadline flows — §4.5) by capping RLI at K-2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["MLUConfig", "mlu", "mlu_level", "geometric_thresholds", "rli_level"]


@dataclass(frozen=True)
class MLUConfig:
    K: int = 8          # number of physical priority levels
    E: float = 4.0      # geometric ratio of the threshold ladder
    U: float = 0.5      # top threshold: MLU >= U ==> critical (level 1)

    def thresholds(self):
        return geometric_thresholds(self.K, self.E, self.U)


def mlu(size_rem: float, time_rem: float, bandwidth: float, rho: float = 0.0) -> float:
    """Minimal Link Utilization of a deadline flow.

    ``bandwidth`` is the bottleneck link capacity along the flow's path and
    ``rho`` the measured background load on it; ``B * (1 - rho)`` is the
    effective residual capacity. A non-positive time budget (deadline passed
    or now) with work remaining is infinite urgency.
    """
    if size_rem <= 0.0:
        return 0.0
    eff = bandwidth * max(0.0, 1.0 - rho)
    if time_rem <= 0.0 or eff <= 0.0:
        return math.inf
    return size_rem / (time_rem * eff)


def geometric_thresholds(K: int, E: float = 4.0, U: float = 0.5):
    """Promotion thresholds Q_i = E^(-i) * U for i = 1..K-1 (descending).

    Q_K is implicitly -inf (``tau_K = +inf`` in deadline terms): arbitrarily
    loose flows are still captured by the lowest-priority queue.
    """
    if K < 2:
        raise ValueError("need at least two priority levels")
    if E <= 1.0:
        raise ValueError("geometric ratio must exceed 1")
    return [U * E ** (-i) for i in range(1, K)]


def mlu_level(value: float, cfg: MLUConfig = MLUConfig()) -> int:
    """Map an MLU value to a discrete RMLQ level (1 = highest priority).

    MLU > 1 "signifies an infeasible overload state" (§4.3): even exclusive
    service cannot meet the deadline, so promoting the flow would burn scarce
    bandwidth on an inevitable miss (the EDF domino / Black-Hole failure the
    paper is explicitly avoiding). Infeasible flows stay in the lowest queue
    and drain opportunistically.
    """
    if not math.isfinite(value) or value > 1.0:
        return cfg.K
    if value >= cfg.U:
        return 1
    # thresholds[i-1] = Q_i;  MLU in [Q_i, Q_{i-1}) -> level i+1
    for i, q in enumerate(cfg.thresholds(), start=1):
        if value >= q:
            return i + 1
    return cfg.K


def rli_level(rli: int, cfg: MLUConfig = MLUConfig()) -> int:
    """Map a Relative Layer Index to an RMLQ level.

    Stage 2 flows have RLI = 0 and "directly enter the high priority queue"
    (§4.5) — i.e. level 2, the top of the implicit-deadline band (level 1 is
    reserved for critical explicit-deadline flows). Stage 1 lookahead flows
    start at 2 + RLI and are promoted as computation advances. The paper caps
    the physical mapping at the lowest queue (§5).
    """
    if rli < 0:
        rli = 0
    return min(cfg.K, 2 + rli)
