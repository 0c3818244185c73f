"""Scheduling policies: the paper's baselines + shared interface.

A ``Policy`` observes scheduling events and (re)assigns, in place, each active
flow's ``priority_key`` (lexicographic, smaller = more urgent) and optional
``rate_cap``. The fluid network model (repro.netsim) then allocates bandwidth
by strict priority over keys with max-min fair sharing among equal keys,
honouring rate caps — exactly the "software strict-priority queues + limited
hardware classes" enforcement model of §5.

Baselines (§6.3):

  * FairShare — max-min fairness among all concurrent flows, size/deadline
    agnostic (DCTCP-style).
  * SJF — strict Shortest-Remaining-First (pFabric-style); minimises mean FCT
    but starves large urgent transfers and over-prioritises small KV flows.
  * EDF — strict Earliest-Deadline-First among explicit-deadline flows;
    degrades to fair sharing for implicit-deadline flows (application
    deadlines do not translate to flow deadlines), and over-prioritises
    Stage 3.
  * Karuna — mix-flow scheduling [17]: deadline flows are paced at the
    minimal rate that meets their deadline (highest class, rate-capped);
    remaining bandwidth goes to non-deadline flows ordered by SJF.

Decode plane: D2D KV-migration flows (Stage.D2D, derived next-token
deadlines) reach every policy through the same ``assign`` path. The
baselines stay stage-agnostic by construction — EDF and Karuna treat a
tight-deadline migration like any deadline flow (and will happily starve
prefill P2D/collectives for it), SJF sorts the large migrations last,
FairShare splits with them evenly. Only the MFS arbiter
(repro.core.arbiter) is decode-aware: D2D gets its own RMLQ laxity and a
band below P2D, so overload control defers loose rebalancing first.

KV-reuse plane: Stage.WB writeback/replication flows carry *loose* derived
deadlines that are nevertheless often nearer than fresh P2D deadlines —
EDF therefore serves background replication ahead of TTFT-critical
traffic once it shares a contended uplink, Karuna reserves it a minimal
rate, FairShare splits with it evenly. MFS holds WB in the band below
even D2D and promotes it only as its own slack runs out.

The MFS policy itself lives in repro.core.arbiter.
"""
from __future__ import annotations

from typing import Iterable, Optional, Protocol, Sequence, Tuple

from .msflow import Flow, FlowState, Stage

__all__ = [
    "SchedView",
    "Policy",
    "FairShare",
    "SJF",
    "EDF",
    "Karuna",
    "LLFOracle",
    "make_policy",
]


class SchedView(Protocol):
    """What a policy may observe (implemented by the cluster simulator)."""

    now: float

    def bottleneck(self, flow: Flow) -> Tuple[float, float]:
        """(capacity, background load rho) of the flow's bottleneck link."""
        ...

    def l_curr(self, unit: int) -> int:
        """Index of the layer currently executing/ready on ``unit``."""
        ...

    def computing(self, rid: int) -> bool:
        """True while the request's prefill computation is still running."""
        ...

    def red_rank(self, rid: int) -> int:
        """Rank of the request's batch in the RED dispatch order sigma."""
        ...

    def downstream_estimate(self, flow: Flow) -> float:
        """Estimated remaining downstream (compute + comm) time after this
        flow completes — used only by the clairvoyant LLF oracle."""
        ...

    def mlu_inputs(self, flow: Flow, level: int) -> Tuple[float, float]:
        """(capacity, rho) for the MLU computation, where rho counts only
        *protected* traffic — flows the candidate could not preempt even if
        promoted to ``level`` (early-stage flows and explicit-deadline flows
        already above that level). Defaults to :meth:`bottleneck`."""
        ...


class Policy:
    name = "base"
    #: whether repro.simcluster should run Algorithm 1 (RED + pruning)
    uses_inter_request = False

    def assign(self, flows: Sequence[Flow], view: SchedView,
               trigger: Tuple = ("event",)) -> None:
        raise NotImplementedError

    def on_flow_submitted(self, flow: Flow, view: SchedView) -> None:
        """Hook for per-flow admission (MFS uses it for RMLQ insertion)."""

    def on_flow_completed(self, flow: Flow, view: SchedView) -> None:
        """Hook for completion bookkeeping."""

    def reset(self) -> None:
        """Clear cross-run state (schedulers are reused across sim runs)."""


class FairShare(Policy):
    name = "fairshare"

    def assign(self, flows, view, trigger=("event",)):
        for f in flows:
            f.priority_key = (0.0, 0.0)
            f.rate_cap = None


class SJF(Policy):
    name = "sjf"

    def assign(self, flows, view, trigger=("event",)):
        for f in flows:
            f.priority_key = (f.remaining, float(f.fid))
            f.rate_cap = None


class EDF(Policy):
    name = "edf"

    def assign(self, flows, view, trigger=("event",)):
        for f in flows:
            if f.explicit_deadline:
                f.priority_key = (0.0, f.deadline, float(f.fid))
            else:
                f.priority_key = (1.0, 0.0, 0.0)   # fair share band
            f.rate_cap = None


class Karuna(Policy):
    name = "karuna"

    def assign(self, flows, view, trigger=("event",)):
        for f in flows:
            if f.explicit_deadline:
                budget = f.deadline - view.now
                if budget <= 0:
                    # overdue: full throttle at top priority (type-1 behaviour)
                    f.priority_key = (0.0, 0.0, float(f.fid))
                    f.rate_cap = None
                else:
                    f.priority_key = (0.0, 0.0, float(f.fid))
                    f.rate_cap = f.remaining / budget   # minimal required rate
            else:
                f.priority_key = (1.0, f.remaining, float(f.fid))  # SJF band
                f.rate_cap = None


class LLFOracle(Policy):
    """Clairvoyant Least-Laxity-First upper bound.

    MFS *approximates* LLF without knowing laxity (§1); this oracle is given
    the simulator's own downstream estimates, yielding the policy MFS aims
    for. Reported in benchmarks as a ceiling, not a baseline from the paper.
    """

    name = "llf-oracle"

    def assign(self, flows, view, trigger=("event",)):
        for f in flows:
            cap, rho = view.bottleneck(f)
            eff = max(cap * (1.0 - rho), 1e-9)
            xmit = f.remaining / eff
            if f.explicit_deadline:
                laxity = f.deadline - view.now - xmit
            else:
                laxity = max(0.0, view.downstream_estimate(f) - xmit)
            f.priority_key = (laxity, float(f.fid))
            f.rate_cap = None


def make_policy(name: str, **kw) -> Policy:
    from .arbiter import MFSScheduler  # local import: avoid cycle

    table = {
        "fairshare": FairShare,
        "fs": FairShare,
        "sjf": SJF,
        "edf": EDF,
        "karuna": Karuna,
        "llf-oracle": LLFOracle,
        "mfs": MFSScheduler,
    }
    if name not in table:
        raise KeyError(f"unknown policy {name!r}; choose from {sorted(table)}")
    return table[name](**kw) if name == "mfs" else table[name]()
