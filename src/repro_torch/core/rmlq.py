"""Reverse Multi-Level Queue (RMLQ) — §4.2.

The RMLQ inverts the classic MLFQ discipline: instead of *demoting* flows
over time, every flow is initialised in a **low**-priority queue (deferral)
and is **monotonically promoted** toward higher priority strictly when its
diminishing effective laxity demands immediate service (Defer-and-Promote).

Invariants enforced here (and property-tested in tests/test_core_rmlq.py):

  I1 (monotonicity)   a flow's level never increases — promotion only.
  I2 (atomicity)      promotion is applied at layer boundaries, never within
                      a message, so a message is never fragmented across
                      priority levels (no packet re-ordering — §4.3).
  I3 (reservation)    level 1 admits only explicit-deadline flows whose MLU
                      has crossed the critical threshold U (§4.5).
  I4 (capture)        tau_K = +inf: any flow, however loose, is held by the
                      lowest queue rather than dropped.

The RMLQ itself is a passive priority structure; *when* levels change is
decided by the arbiter (repro.core.arbiter.MFSScheduler), which calls
``promote`` at layer boundaries / periodic ticks per the paper's rules.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from .msflow import Flow, FlowState, Stage
from .urgency import MLUConfig

__all__ = ["RMLQ"]


class RMLQ:
    """K strict-priority queues + one scavenger class (level K+1)."""

    def __init__(self, cfg: MLUConfig = MLUConfig()):
        self.cfg = cfg
        self.K = cfg.K
        self._queues: List[Dict[int, Flow]] = [dict() for _ in range(cfg.K + 2)]
        self._level: Dict[int, int] = {}
        #: optional decision-audit sink (repro.core.telemetry.Telemetry);
        #: None keeps every record site a single falsy check
        self.audit = None

    # ------------------------------------------------------------------ admin
    def insert(self, flow: Flow, level: int) -> None:
        """Admit a flow at its initial (deferred) level."""
        clamped = self._clamp(level, flow)
        if flow.fid in self._level:
            raise ValueError(f"flow {flow.fid} already queued")
        self._level[flow.fid] = clamped
        flow.level = clamped
        self._queues[clamped][flow.fid] = flow
        if self.audit is not None:
            self.audit.rmlq_event("insert", flow, None, clamped)
            if level < clamped == 2:
                # I3 band clamp: the flow asked for the critical reservation
                # but its band (D2D/WB or no explicit deadline) bars level 1
                self.audit.rmlq_event("clamp", flow, level, clamped)

    def remove(self, flow: Flow) -> None:
        lvl = self._level.pop(flow.fid, None)
        if lvl is not None:
            self._queues[lvl].pop(flow.fid, None)

    def __contains__(self, flow: Flow) -> bool:
        return flow.fid in self._level

    def level_of(self, flow: Flow) -> Optional[int]:
        return self._level.get(flow.fid)

    # -------------------------------------------------------------- promotion
    def promote(self, flow: Flow, new_level: int) -> bool:
        """Move ``flow`` to ``new_level`` iff that is a strict promotion.

        Returns True when the flow actually moved. Demotion requests are
        ignored (I1): the Defer-and-Promote principle deliberately forbids
        priority oscillation, keeping flows in lower tiers until urgency
        strictly necessitates promotion.
        """
        cur = self._level.get(flow.fid)
        if cur is None:
            raise KeyError(f"flow {flow.fid} not queued")
        wanted = new_level
        new_level = self._clamp(new_level, flow)
        if new_level >= cur:
            if self.audit is not None and wanted < new_level == 2 \
                    and wanted < cur:
                # the urgency called for level 1 but the band clamp held the
                # flow back — an invisible non-decision without the audit
                self.audit.rmlq_event("clamp", flow, wanted, new_level)
            return False
        del self._queues[cur][flow.fid]
        self._queues[new_level][flow.fid] = flow
        self._level[flow.fid] = new_level
        flow.level = new_level
        if self.audit is not None:
            self.audit.rmlq_event("promote", flow, cur, new_level)
            if wanted < new_level == 2:
                self.audit.rmlq_event("clamp", flow, wanted, new_level)
        return True

    def demote_to_scavenger(self, flow: Flow) -> None:
        """Overload control (Appendix B): soft-enforce pruning by demoting the
        flow to the scavenger class instead of dropping it. This is the single
        sanctioned exception to I1 and is recorded on the flow state."""
        cur = self._level.get(flow.fid)
        if cur is None:
            return
        del self._queues[cur][flow.fid]
        lvl = self.K + 1
        self._queues[lvl][flow.fid] = flow
        self._level[flow.fid] = lvl
        flow.level = lvl
        flow.state = FlowState.PRUNED
        if self.audit is not None:
            self.audit.rmlq_event("scavenge", flow, cur, lvl)

    def readmit(self, flow: Flow, level: int) -> None:
        """Re-admit a scavenged flow (runtime turned out better than the
        worst-case estimate)."""
        if self._level.get(flow.fid) != self.K + 1:
            return
        del self._queues[self.K + 1][flow.fid]
        level = self._clamp(level, flow)
        self._queues[level][flow.fid] = flow
        self._level[flow.fid] = level
        flow.level = level
        flow.state = FlowState.ACTIVE
        if self.audit is not None:
            self.audit.rmlq_event("readmit", flow, self.K + 1, level)

    # ---------------------------------------------------------------- queries
    def flows(self, level: Optional[int] = None) -> Iterable[Flow]:
        if level is not None:
            return list(self._queues[level].values())
        out: List[Flow] = []
        for q in self._queues[1:]:
            out.extend(q.values())
        return out

    def occupancy(self) -> List[int]:
        return [len(q) for q in self._queues]

    def _clamp(self, level: int, flow: Flow) -> int:
        # I3: level 1 is reserved for explicit-deadline *completion* (Stage 3)
        # flows. D2D rebalancing and KV-store writebacks carry derived
        # deadlines too, but both are deferrable by design (overload control
        # trades them against P2D), so they never enter the critical
        # reservation.
        lo = 1 if (flow.explicit_deadline
                   and flow.stage not in (Stage.D2D, Stage.WB)) else 2
        return max(lo, min(self.K, level))
