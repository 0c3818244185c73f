"""MFS — the full Defer-and-Promote arbiter over the RMLQ substrate (§4.5).

Per-stage rules
---------------
* Stage 3 (P2D, explicit deadline): initial level and promotions come from the
  MLU geometric ladder (§4.3). Levels are re-evaluated at *layer boundaries*
  while the owning request is still computing, then at *periodic ticks* once
  computation has finished. Promotion is monotone and message-atomic.
* Stage 1 (KV reuse, implicit deadline): initial level = rli_level(RLI); as
  the compute front L_curr advances the RLI shrinks, promoting the flow
  "incrementally at layer boundaries to align with computation progress".
* Stage 2 (collectives, implicit deadline): RLI = 0 by construction — they
  block the next computation step — so they enter the top of the implicit
  band (level 2) directly.
* D2D (decode KV migration, derived deadline): same MLU ladder as Stage 3
  over its next-token (TPOT) deadline, re-evaluated on periodic ticks; at
  equal level it sits in a band *below* P2D and is barred from the level-1
  critical reservation — rebalancing is the first traffic overload control
  defers when tight-TTFT P2D needs the downlink.
* WB (KV-store writeback/replication, loose derived deadline): same MLU
  ladder and tick-driven re-evaluation, one band *below even D2D* and also
  barred from level 1 — background replication is the very last thing that
  may touch a contended link; it only promotes as its own loose deadline
  actually runs out.

Arbitration (§4.5)
------------------
Level 1 is reserved for critical explicit-deadline flows (MLU >= U). Within
each remaining level, early-stage (implicit-deadline) flows take precedence
over last-stage flows so deferred P2D traffic only opportunistically uses
bandwidth; ties among early-stage flows with equal RLI follow the RED rank
sigma from the inter-request scheduler (§4.4.2). Equal keys share bandwidth
max-min fairly, which also spreads a coflow's members evenly.

Priority-key layout (lexicographic, smaller = more urgent):

    (level, band, red_rank)
      level    1..K from the RMLQ, K+1 = scavenger
      band     0 = early-stage (Stages 1-2), 1 = last-stage (Stage 3),
               2 = decode-plane D2D rebalancing, 3 = KV-store writeback
      red_rank rank of the owning batch in sigma (0 when unused)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .msflow import Flow, FlowState, Stage
from .policies import Policy, SchedView
from .rmlq import RMLQ
from .urgency import MLUConfig, mlu, mlu_level, rli_level

__all__ = ["MFSScheduler"]


class MFSScheduler(Policy):
    name = "mfs"
    uses_inter_request = True

    def __init__(self, cfg: MLUConfig = MLUConfig(), tick_interval: float = 2e-3):
        self.cfg = cfg
        #: periodic MLU re-evaluation pitch once a request finished computing
        self.tick_interval = tick_interval
        self.rmlq = RMLQ(cfg)
        #: optional telemetry collector — receives the RMLQ decision audit
        #: plus the MLU/RLI inputs computed right before each decision
        self.telemetry = None

    # ------------------------------------------------------------ admission
    def on_flow_submitted(self, flow: Flow, view: SchedView) -> None:
        self.rmlq.insert(flow, self._target_level(flow, view))

    def on_flow_completed(self, flow: Flow, view: SchedView) -> None:
        self.rmlq.remove(flow)

    def reset(self) -> None:
        self.rmlq = RMLQ(self.cfg)
        self.rmlq.audit = self.telemetry

    def attach_telemetry(self, telemetry) -> None:
        """Route the RMLQ decision audit into ``telemetry`` (survives
        ``reset()``; pass None to detach)."""
        self.telemetry = telemetry
        self.rmlq.audit = telemetry

    # ------------------------------------------------------------ promotion
    def _target_level(self, flow: Flow, view: SchedView) -> int:
        tel = self.telemetry
        if flow.stage in (Stage.P2D, Stage.D2D, Stage.WB):
            # D2D rebalancing and KV-store writebacks enter the RMLQ with
            # their own laxity: the same MLU ladder over their derived
            # deadlines (next-token TPOT budget / loose replication slack),
            # so they promote only as that budget actually runs out
            # (deferred otherwise — P2D wins the tie via the band)
            lvl = min(flow.level, self.cfg.K)
            try:
                cap, rho = view.mlu_inputs(flow, lvl)
            except (AttributeError, NotImplementedError):
                cap, rho = view.bottleneck(flow)
            laxity = flow.deadline - view.now
            u = mlu(flow.remaining, laxity, cap, rho)
            if tel is not None:
                tel.note_urgency(flow.fid, {
                    "mlu": u, "laxity": laxity, "remaining": flow.remaining,
                    "cap": cap, "rho": rho})
            return mlu_level(u, self.cfg)
        if flow.stage == Stage.COLLECTIVE:
            return 2                       # RLI = 0: top of the implicit band
        rli = max(0, flow.target_layer - view.l_curr(flow.unit))
        if tel is not None:
            tel.note_urgency(flow.fid, {
                "rli": rli, "target_layer": flow.target_layer,
                "l_curr": view.l_curr(flow.unit)})
        return rli_level(rli, self.cfg)

    def assign(self, flows: Sequence[Flow], view: SchedView,
               trigger: Tuple = ("event",)) -> None:
        kind = trigger[0]
        unit = trigger[1] if len(trigger) > 1 else None
        for f in flows:
            if f.state == FlowState.PRUNED:
                # Scavenger class: opportunistic leftovers only (Appendix B
                # "soft enforcement"); strict-priority water-filling hands it
                # whatever the admitted classes leave on the table.
                f.priority_key = (self.cfg.K + 1, 1, 0)
                f.rate_cap = None
                continue
            if f not in self.rmlq:          # e.g. re-admitted after pruning
                self.rmlq.insert(f, self._target_level(f, view))
            if self._should_reevaluate(f, view, kind, unit):
                self.rmlq.promote(f, self._target_level(f, view))
            # band: early stages (1-2) > last-stage P2D > D2D rebalancing >
            # KV-store writeback — at equal level, loose-SLO decode
            # migration and background replication are the first things
            # overload control defers in favor of tight-TTFT P2D
            band = {Stage.P2D: 1, Stage.D2D: 2, Stage.WB: 3}.get(f.stage, 0)
            red = view.red_rank(f.rid)
            f.priority_key = (f.level, band, red)
            f.rate_cap = None

    def _should_reevaluate(self, f: Flow, view: SchedView,
                           kind: str, unit: Optional[int]) -> bool:
        if kind == "submit":
            return False                    # level was just computed
        if f.stage == Stage.P2D:
            if view.computing(f.rid):
                # layer-boundary granularity while computing (C-1: priority
                # atomicity at message level, no packet re-ordering)
                return kind == "layer" and unit == f.unit
            return kind == "tick"           # fixed-interval updates afterwards
        if f.stage in (Stage.D2D, Stage.WB):
            return kind == "tick"           # no layer boundaries to ride
        if f.stage == Stage.KV_REUSE:
            return kind == "layer" and unit == f.unit
        return False                        # Stage 2 never moves (already top)

    # ------------------------------------------------- overload-control hooks
    def prune(self, flow: Flow) -> None:
        self.rmlq.demote_to_scavenger(flow)

    def readmit(self, flow: Flow, view: SchedView) -> None:
        self.rmlq.readmit(flow, self._target_level(flow, view))
