"""Telemetry plane — stage-aware tracing, decision audit, link attribution.

The paper's central claim is that *uncoordinated cross-stage contention on
shared bottleneck links* is the primary cause of TTFT SLO violations. The
rest of the repro can only report end-of-run attainment ratios; this module
makes the mechanism observable: **where a missed request's slack went**
(which stage, which link, queueing vs transfer vs compute) and **what RMLQ
decided and when** (defer level, promotions with the MLU/RLI inputs that
drove them, band clamps, level-1 reservations, Algorithm-1 re-evaluations).

Pieces:

  * :class:`TelemetrySpec` — the knob carried by ``ClusterSpec.telemetry``
    / ``DisaggConfig.telemetry``; ``None`` (the default everywhere) keeps
    the runtime byte-identical to the pre-telemetry code path.
  * :class:`Telemetry` — the collector both hosts attach to the shared
    ``MsFlowRuntime``. Near-zero overhead when absent: every probe site is
    a single ``if tel is not None`` guard, and the collector itself never
    perturbs scheduling (it only reads clock/net state), so TTFTs and
    stage traces with telemetry ON equal the OFF run bit-for-bit.
  * :class:`StageLog` — the bounded stage-trace deque, now counting what
    it drops (the legacy ``deque(maxlen=...)`` lost oldest entries with no
    signal); ``runtime.stage_log`` keeps the historical
    ``(rid, stage, group, size, deadline)`` row format.

What gets recorded (all bounded; drops are counted, never silent):

  * **Request-lifecycle spans** — arrive → route/admit (incl. defer/shed)
    → batch → per-(group, chunk) compute → collective waits → P2D tail →
    first token → decode admit/steps summary → D2D migrations → eviction,
    as per-request event lists plus per-flow spans carrying submit/finish
    times, bytes, a rate-history summary (max rate, #rate changes, time at
    zero rate vs transferring) and the bottleneck link at completion.
  * **Scheduler-decision audit** — every RMLQ insert (the *defer* level),
    promotion, band clamp (D2D/WB barred from the level-1 reservation),
    level-1 reservation entry, scavenge/readmit, and every Algorithm-1
    inter-request re-evaluation (order + pruned set), with the MLU/RLI
    inputs captured at decision time by the arbiter.
  * **Link telemetry** — time-integrated per-link utilization and
    per-stage-class byte shares (generalizing the KV store's one-off
    ``sample_contention``), sampled at ``link_dt`` pitch, plus contended
    time (utilization ≥ ``contended_util``) per link.

Analysis + export:

  * :meth:`Telemetry.ttft_breakdown` — per-request slack attribution
    (queue / S1 stall / compute / collective wait / P2D tail / per-stage
    network queueing-vs-transfer).
  * :meth:`Telemetry.slo_miss_report` — ranks missed requests' dominant
    (stage, link) causes per run; the benchmark's per-policy
    contention-attribution table comes from this.
  * :meth:`Telemetry.to_chrome_trace` — Chrome/Perfetto trace-event JSON,
    so a sweep run renders as an inspectable timeline.

Control-plane only (no JAX), host-agnostic like the rest of ``repro.core``.
"""
from __future__ import annotations

import json
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Set,
                    Tuple)

from .msflow import Flow, FlowState, Stage

__all__ = ["TelemetrySpec", "Telemetry", "StageLog", "FlowSpan",
           "RequestTrace", "link_name"]


# --------------------------------------------------------------------- spec
@dataclass(frozen=True)
class TelemetrySpec:
    """Telemetry-plane configuration (attach via ``ClusterSpec.telemetry``
    or ``DisaggConfig.telemetry``; ``None`` disables the plane entirely)."""

    enabled: bool = True
    audit: bool = True            # RMLQ / Algorithm-1 decision audit
    link_sampling: bool = True    # per-link per-stage-class accounting
    link_dt: float = 2e-3         # link-sampling pitch (s of sim time); the
    #                               per-flow span rate summary is exact
    #                               regardless — only the per-link byte
    #                               attribution is sampled at this pitch
    contended_util: float = 0.9   # a link counts as contended at ≥ this rho
    max_flow_spans: int = 200_000
    max_audit_events: int = 200_000
    max_request_events: int = 512   # per-request lifecycle event cap
    max_compute_spans: int = 100_000


# ---------------------------------------------------------------- stage log
class StageLog(deque):
    """Bounded stage-trace deque that COUNTS what it drops.

    The legacy ``deque(maxlen=...)`` silently discarded the oldest rows on
    overflow; parity tests comparing truncated logs would then diverge with
    no signal. This subclass keeps the exact row format and iteration
    semantics but increments :attr:`dropped` per lost row and warns once."""

    def __init__(self, maxlen: int = 100_000):
        super().__init__(maxlen=maxlen)
        self.dropped = 0

    def append(self, row) -> None:
        if self.maxlen is not None and len(self) == self.maxlen:
            self.dropped += 1
            if self.dropped == 1:
                warnings.warn(
                    f"stage_log overflowed its {self.maxlen}-row bound; "
                    "oldest entries are being dropped (raise "
                    "stage_log_limit or consume the log incrementally)",
                    RuntimeWarning, stacklevel=3)
        super().append(row)


# ------------------------------------------------------------------ records
@dataclass
class FlowSpan:
    """One submitted flow's life, with a rate-history summary."""

    fid: int
    rid: int
    unit: int
    stage: Stage
    group: int                    # target_layer (S1: consuming group)
    size: float
    deadline: Optional[float]
    created: float
    src: int = -1
    dst: int = -1
    line_cap: float = 0.0         # min capacity over the static route
    finished: Optional[float] = None
    end_state: str = "open"       # open | done | cancelled | pruned
    level0: int = 0               # RMLQ level at submission
    level_final: int = 0
    max_rate: float = 0.0
    rate_changes: int = 0
    idle: float = 0.0             # time active at zero allocated rate
    xfer: float = 0.0             # time active at non-zero rate
    bottleneck: int = -1          # most-utilized route link at completion
    _last_rate: float = -1.0

    @property
    def duration(self) -> float:
        return (self.finished - self.created) \
            if self.finished is not None else 0.0

    @property
    def excess(self) -> float:
        """Slack this flow burned on the network: time queued at zero rate
        plus transfer time beyond the route's line-rate serialization."""
        ideal = self.size / self.line_cap if self.line_cap > 0 else 0.0
        return self.idle + max(0.0, self.xfer - ideal)


@dataclass
class RequestTrace:
    """Per-request lifecycle: ordered events + summary fields."""

    rid: int
    arrival: float = 0.0
    unit: int = -1
    slo_class: str = "standard"
    deadline: Optional[float] = None     # absolute
    ideal_ttft: float = 0.0
    batch: int = -1
    batch_started: Optional[float] = None
    prefill_done: Optional[float] = None
    p2d_last: Optional[float] = None
    stalls: float = 0.0
    ttft: Optional[float] = None         # relative, as reported by metrics
    status: str = "arrived"   # arrived|deferred|shed|admitted|served|pruned
    n_deferrals: int = 0
    events: List[Tuple[float, str, Any]] = field(default_factory=list)
    flows: List[int] = field(default_factory=list)
    events_dropped: int = 0

    def missed(self) -> Optional[bool]:
        if self.status == "shed":
            return True
        if self.ttft is None or self.deadline is None:
            return None
        return self.arrival + self.ttft > self.deadline + 1e-9


def link_name(topo: Any, lid: int) -> str:
    """Best-effort human-readable name for a topology link id."""
    n = getattr(topo, "n_nodes", 0)
    su = getattr(topo, "_su", None)
    up0, dn0 = getattr(topo, "_up0", None), getattr(topo, "_dn0", None)
    if lid < 2 * n:
        return f"nic{lid // 2}.{'up' if lid % 2 == 0 else 'down'}"
    if up0 is not None and dn0 is not None and up0 <= lid < dn0:
        ns = topo.n_spines
        r, s = divmod(lid - up0, ns)
        return f"leaf{r}->spine{s}"
    if up0 is not None and dn0 is not None and su is not None \
            and dn0 <= lid < su:
        ns = topo.n_spines
        r, s = divmod(lid - dn0, ns)
        return f"spine{s}->leaf{r}"
    if su is not None and lid >= su:
        j = lid - su
        return f"su{j // 2}.{'out' if j % 2 == 0 else 'in'}"
    return f"link{lid}"


# ---------------------------------------------------------------- collector
class Telemetry:
    """The telemetry collector one runtime binds (see module docstring).

    Pure observer: reads the runtime clock / fluid-net state, never mutates
    either — enabling it cannot change scheduling outcomes (regression-
    tested: TTFTs and stage traces match the telemetry-off run exactly)."""

    def __init__(self, spec: TelemetrySpec = TelemetrySpec()):
        self.spec = spec
        self._clock: Callable[[], float] = lambda: 0.0
        self.topo: Any = None
        # request lifecycle
        self.requests: Dict[int, RequestTrace] = {}
        # flow spans (kept after close — they ARE the history)
        self.flow_spans: Dict[int, FlowSpan] = {}
        # compute spans: (unit, bid, group, chunk, t0, t1)
        self.compute_spans: List[Tuple[int, int, int, int, float, float]] = []
        self._open_compute: Dict[int, Tuple[int, int, int, float]] = {}
        self.batch_compute: Dict[int, float] = {}    # bid -> compute seconds
        self.batch_coll_wait: Dict[int, float] = {}  # bid -> Stage-2 waits
        # scheduler-decision audit
        self.audit: List[Dict[str, Any]] = []
        self._urgency: Dict[int, Dict[str, Any]] = {}   # fid -> last inputs
        self._levels: Dict[int, Tuple[Stage, int, int]] = {}  # fid ->
        #                                   (stage, insert level, last level)
        # link telemetry (time-integrated)
        self.link_byte_time: Dict[int, float] = {}   # ∫ used_rate dt
        self.link_stage_bytes: Dict[Tuple[int, str], float] = {}
        self.link_contended_time: Dict[int, float] = {}
        self.contended_stage_bytes: Dict[Tuple[int, str], float] = {}
        self._t_link = 0.0          # last link sample time
        self._t0: Optional[float] = None
        self._t_end = 0.0
        self.t_first_decode = 0.0   # set by the runtime at bind
        self.dropped = {"flow_spans": 0, "audit": 0, "request_events": 0,
                        "compute_spans": 0}

    # -------------------------------------------------------------- binding
    def bind(self, clock: Callable[[], float], topo: Any,
             t_first_decode: float = 0.0) -> None:
        self._clock = clock
        self.topo = topo
        self.t_first_decode = t_first_decode

    def _now(self) -> float:
        return self._clock()

    # ---------------------------------------------------- request lifecycle
    def _trace(self, rid: int) -> RequestTrace:
        tr = self.requests.get(rid)
        if tr is None:
            tr = self.requests[rid] = RequestTrace(rid=rid)
        return tr

    def request_event(self, rid: int, kind: str, arg: Any = None,
                      t: Optional[float] = None) -> None:
        tr = self._trace(rid)
        if len(tr.events) >= self.spec.max_request_events:
            tr.events_dropped += 1
            self.dropped["request_events"] += 1
            return
        tr.events.append((self._now() if t is None else t, kind, arg))

    def on_arrival(self, item: Any, unit: int) -> None:
        tr = self._trace(item.rid)
        if item.deferrals == 0 and not tr.events:
            tr.arrival = item.arrival
            self.request_event(item.rid, "arrive", t=item.arrival)
        self.request_event(item.rid, "route",
                           {"unit": unit, "reuse": item.reuse})

    def on_admitted(self, item: Any) -> None:
        tr = self._trace(item.rid)
        tr.status = "admitted"
        tr.unit = item.unit
        tr.slo_class = item.slo_class
        tr.deadline = item.deadline
        tr.ideal_ttft = item.ideal_ttft
        self.request_event(item.rid, "admit", {"unit": item.unit,
                                               "deadline": item.deadline})

    def on_deferred(self, item: Any) -> None:
        tr = self._trace(item.rid)
        tr.status = "deferred"
        tr.n_deferrals = item.deferrals
        tr.slo_class = item.slo_class
        self.request_event(item.rid, "defer", {"n": item.deferrals})

    def on_shed(self, item: Any) -> None:
        tr = self._trace(item.rid)
        tr.status = "shed"
        tr.slo_class = item.slo_class
        tr.deadline = item.deadline
        self.request_event(item.rid, "shed", {"class": item.slo_class})

    def on_batch_started(self, bs: Any) -> None:
        for it in bs.items:
            tr = self._trace(it.rid)
            tr.batch = bs.bid
            tr.batch_started = bs.started
            self.request_event(it.rid, "batch",
                               {"bid": bs.bid, "unit": bs.unit})

    def on_request_done(self, item: Any, bs: Any) -> None:
        tr = self._trace(item.rid)
        tr.status = "served"
        tr.ttft = item.ttft
        tr.prefill_done = item.prefill_done
        tr.p2d_last = bs.p2d_last.get(item.rid)
        tr.stalls = item.stalls
        tr.deadline = item.deadline
        self.request_event(item.rid, "first_token", {"ttft": item.ttft})

    def on_pruned(self, rid: int) -> None:
        tr = self._trace(rid)
        tr.status = "pruned"
        self.request_event(rid, "pruned")

    def on_readmitted(self, rid: int) -> None:
        tr = self._trace(rid)
        if tr.status == "pruned":
            tr.status = "admitted"
        self.request_event(rid, "readmitted")

    # -------------------------------------------------------------- compute
    def compute_open(self, bs: Any, g: int, c: int) -> None:
        self._open_compute[bs.unit] = (bs.bid, g, c, self._now())

    def compute_close(self, unit: int) -> None:
        ent = self._open_compute.pop(unit, None)
        if ent is None:
            return
        bid, g, c, t0 = ent
        t1 = self._now()
        self.batch_compute[bid] = self.batch_compute.get(bid, 0.0) + (t1 - t0)
        if len(self.compute_spans) >= self.spec.max_compute_spans:
            self.dropped["compute_spans"] += 1
            return
        self.compute_spans.append((unit, bid, g, c, t0, t1))

    def coll_wait(self, bid: int, dt: float) -> None:
        self.batch_coll_wait[bid] = self.batch_coll_wait.get(bid, 0.0) + dt

    # ----------------------------------------------------------- flow spans
    def flow_submitted(self, flow: Flow,
                       stage_log: Optional[StageLog] = None) -> None:
        """Open a span for a submitted flow. When ``stage_log`` is given the
        legacy ``(rid, stage, group, size, deadline)`` row is appended too —
        with telemetry on, the stage log is backed by this single probe."""
        if stage_log is not None:
            stage_log.append((flow.rid, flow.stage, flow.target_layer,
                              flow.size, flow.deadline))
        if len(self.flow_spans) >= self.spec.max_flow_spans:
            self.dropped["flow_spans"] += 1
            return
        route = self.topo.route(flow.src, flow.dst, flow.fid) \
            if self.topo is not None else ()
        cap = min((self.topo.capacity[l] for l in route), default=0.0) \
            if route else 0.0
        sp = FlowSpan(fid=flow.fid, rid=flow.rid, unit=flow.unit,
                      stage=flow.stage, group=flow.target_layer,
                      size=flow.size, deadline=flow.deadline,
                      created=flow.created, src=flow.src, dst=flow.dst,
                      line_cap=cap, level0=flow.level,
                      level_final=flow.level)
        self.flow_spans[flow.fid] = sp
        tr = self._trace(flow.rid)
        tr.flows.append(flow.fid)

    def flow_closed(self, flow: Flow, net: Any) -> None:
        """Close the span (completion, pruning cancellation, or eviction).
        Records the end state, the final RMLQ level and the bottleneck link
        (most-utilized link of the flow's route at close time)."""
        sp = self.flow_spans.get(flow.fid)
        self._urgency.pop(flow.fid, None)
        if sp is None or sp.end_state != "open":
            return
        now = self._now()
        sp.finished = flow.finished if flow.finished is not None else now
        sp.level_final = flow.level
        if flow.state == FlowState.DONE and flow.remaining <= 0:
            sp.end_state = "done"
        elif flow.state == FlowState.PRUNED:
            sp.end_state = "pruned"
        else:
            sp.end_state = "cancelled"
        if self.topo is not None:
            route = self.topo.route(flow.src, flow.dst, flow.fid)
            best, best_rho = -1, -1.0
            lr = getattr(net, "_link_rate", {})
            for lid in route:
                rho = lr.get(lid, 0.0) / self.topo.capacity[lid]
                if rho > best_rho:
                    best, best_rho = lid, rho
            sp.bottleneck = best

    # ------------------------------------------------------ time integration
    def on_advance(self, net: Any, t: float) -> None:
        """Called once per event, BEFORE ``net.advance(t)``: rates are
        piecewise-constant over [net.now, t], so integrating rate × dt here
        is exact for the per-flow span summaries. The per-link per-stage
        byte attribution is sampled at ``link_dt`` pitch to bound cost."""
        now = net.now
        dt = t - now
        if self._t0 is None:
            self._t0 = now
        self._t_end = t
        if dt <= 0.0:
            return
        spans = self.flow_spans
        for f in net.flows.values():
            sp = spans.get(f.fid)
            if sp is None:
                continue
            r = f.rate
            if r > 0.0:
                sp.xfer += dt
                if r != sp._last_rate:
                    sp.rate_changes += 1
                    sp._last_rate = r
                    if r > sp.max_rate:
                        sp.max_rate = r
            else:
                sp.idle += dt
        if not self.spec.link_sampling or t - self._t_link < self.spec.link_dt:
            return
        sdt = t - self._t_link
        self._t_link = t
        lr = getattr(net, "_link_rate", None)
        if not lr:
            return
        cap = self.topo.capacity
        contended: Set[int] = set()
        thr = self.spec.contended_util
        for lid, used in lr.items():
            if used <= 0.0:
                continue
            self.link_byte_time[lid] = \
                self.link_byte_time.get(lid, 0.0) + used * sdt
            if used >= thr * cap[lid]:
                contended.add(lid)
                self.link_contended_time[lid] = \
                    self.link_contended_time.get(lid, 0.0) + sdt
        for f in net.flows.values():
            r = f.rate
            if r <= 0.0:
                continue
            st = f.stage.name
            b = r * sdt
            for lid in net.routes[f.fid]:
                self.link_stage_bytes[(lid, st)] = \
                    self.link_stage_bytes.get((lid, st), 0.0) + b
                if lid in contended:
                    self.contended_stage_bytes[(lid, st)] = \
                        self.contended_stage_bytes.get((lid, st), 0.0) + b

    # ------------------------------------------------------- decision audit
    def note_urgency(self, fid: int, inputs: Dict[str, Any]) -> None:
        """Arbiter side-channel: the MLU/RLI inputs computed immediately
        before an insert/promote decision (popped by :meth:`rmlq_event`)."""
        self._urgency[fid] = inputs

    def rmlq_event(self, kind: str, flow: Flow, frm: Optional[int],
                   to: int) -> None:
        """One RMLQ decision: insert (the defer level), promote, clamp
        (barred from the level-1 reservation), scavenge, or readmit. A
        level-1 outcome is additionally flagged as the §4.5 critical
        reservation entry."""
        if not self.spec.audit:
            return
        if kind == "insert":
            self._levels[flow.fid] = (flow.stage, to, to)
        elif kind in ("promote", "scavenge", "readmit"):
            ent = self._levels.get(flow.fid)
            if ent is not None:
                self._levels[flow.fid] = (ent[0], ent[1], to)
        if len(self.audit) >= self.spec.max_audit_events:
            self.dropped["audit"] += 1
            return
        ev = {"t": self._now(), "kind": kind, "fid": flow.fid,
              "rid": flow.rid, "stage": flow.stage.name, "from": frm,
              "to": to}
        if to == 1 and kind in ("insert", "promote", "readmit"):
            ev["reserved"] = True          # I3: level-1 critical reservation
        inputs = self._urgency.pop(flow.fid, None)
        if inputs is not None and kind in ("insert", "promote", "readmit"):
            ev["inputs"] = inputs
        self.audit.append(ev)

    def red_run(self, order: List[int], pruned: Iterable[int],
                n_batches: int) -> None:
        """One Algorithm-1 inter-request re-evaluation (RED ordering +
        feasibility pruning over the live batches)."""
        if not self.spec.audit:
            return
        if len(self.audit) >= self.spec.max_audit_events:
            self.dropped["audit"] += 1
            return
        self.audit.append({"t": self._now(), "kind": "red_run",
                           "order": list(order), "pruned": sorted(pruned),
                           "n_batches": n_batches})

    def rmlq_promoted_count(self, stage: Optional[Stage] = None) -> int:
        """Flows whose audited final level sits below their insert level —
        matches ``MsFlowRuntime.promoted_count`` by construction (every
        level mutation flows through an audited RMLQ entry point)."""
        name = stage.name if stage is not None else None
        return sum(1 for (st, lvl0, lvl) in self._levels.values()
                   if lvl < lvl0 and (name is None or st.name == name))

    def audit_events(self, kind: Optional[str] = None) -> List[Dict]:
        return [e for e in self.audit if kind is None or e["kind"] == kind]

    # ------------------------------------------------------------- analysis
    def ttft_breakdown(self, rid: int) -> Optional[Dict[str, Any]]:
        """Where the request's TTFT went: admission queue, Stage-1 stalls,
        compute, collective waits, P2D tail, first decode step — plus the
        per-stage network split (queued-at-zero-rate vs transferring) from
        its flow spans. Components sum to the TTFT for served requests."""
        tr = self.requests.get(rid)
        if tr is None:
            return None
        out: Dict[str, Any] = {"rid": rid, "status": tr.status,
                               "slo_class": tr.slo_class, "ttft": tr.ttft,
                               "budget": (tr.deadline - tr.arrival)
                               if tr.deadline is not None else None}
        if tr.ttft is not None and out["budget"] is not None:
            out["slack"] = out["budget"] - tr.ttft
        if tr.batch_started is not None:
            out["queue"] = tr.batch_started - tr.arrival
        if tr.prefill_done is not None and tr.batch_started is not None:
            bid = tr.batch
            stall = tr.stalls
            coll = self.batch_coll_wait.get(bid, 0.0)
            comp = self.batch_compute.get(bid, 0.0)
            out["stall_s1"] = stall
            out["coll_wait"] = coll
            out["compute"] = comp
            last = tr.p2d_last if tr.p2d_last is not None else tr.prefill_done
            out["p2d_tail"] = max(0.0, last - tr.prefill_done)
            out["first_decode"] = self.t_first_decode
        stages: Dict[str, Dict[str, float]] = {}
        for fid in tr.flows:
            sp = self.flow_spans.get(fid)
            if sp is None:
                continue
            d = stages.setdefault(sp.stage.name, {"bytes": 0.0, "idle": 0.0,
                                                  "xfer": 0.0, "excess": 0.0,
                                                  "n": 0})
            d["bytes"] += sp.size
            d["idle"] += sp.idle
            d["xfer"] += sp.xfer
            d["excess"] += sp.excess
            d["n"] += 1
        out["stages"] = stages
        return out

    def attribute_miss(self, rid: int) -> Optional[Dict[str, Any]]:
        """Dominant (stage, link) a missed request's slack went to: the
        flow span with the largest network excess (queueing at zero rate +
        transfer beyond line rate), attributed to its bottleneck link."""
        tr = self.requests.get(rid)
        if tr is None or tr.missed() is not True:
            return None
        rec: Dict[str, Any] = {"rid": rid, "slo_class": tr.slo_class,
                               "status": tr.status}
        if tr.ttft is not None and tr.deadline is not None:
            rec["slack_lost"] = tr.ttft - (tr.deadline - tr.arrival)
        if tr.status == "shed":
            rec["stage"], rec["link"] = "admission", None
            return rec
        best: Optional[FlowSpan] = None
        for fid in tr.flows:
            sp = self.flow_spans.get(fid)
            if sp is None or sp.bottleneck < 0:
                continue
            if best is None or sp.excess > best.excess:
                best = sp
        if best is None:
            rec["stage"], rec["link"] = "compute", None
            return rec
        rec["stage"] = best.stage.name
        rec["link"] = best.bottleneck
        rec["link_name"] = link_name(self.topo, best.bottleneck)
        rec["excess"] = best.excess
        rec["flow_idle"] = best.idle
        rec["flow_xfer"] = best.xfer
        return rec

    def slo_miss_report(self, slo_class: Optional[str] = None,
                        top: int = 10) -> Dict[str, Any]:
        """Rank where missed requests' slack went: per-(stage, link) miss
        counts and total slack lost, plus per-request attributions.
        ``coverage`` = fraction of misses pinned to a concrete
        (stage, link) pair (the acceptance signal)."""
        misses: List[Dict[str, Any]] = []
        for rid, tr in self.requests.items():
            if rid < 0 or tr.missed() is not True:
                continue
            if slo_class is not None and tr.slo_class != slo_class:
                continue
            rec = self.attribute_miss(rid)
            if rec is not None:
                misses.append(rec)
        causes: Dict[Tuple[str, Any], Dict[str, Any]] = {}
        n_attr = 0
        for rec in misses:
            key = (rec["stage"], rec.get("link"))
            if rec.get("link") is not None:
                n_attr += 1
            c = causes.setdefault(key, {"stage": key[0], "link": key[1],
                                        "link_name": rec.get("link_name"),
                                        "n": 0, "slack_lost": 0.0})
            c["n"] += 1
            c["slack_lost"] += max(0.0, rec.get("slack_lost", 0.0))
        ranked = sorted(causes.values(),
                        key=lambda c: (-c["slack_lost"], -c["n"]))
        return {"n_missed": len(misses), "n_attributed": n_attr,
                "coverage": (n_attr / len(misses)) if misses else None,
                "causes": ranked[:top], "requests": misses}

    def link_report(self, top: int = 10) -> List[Dict[str, Any]]:
        """Most-contended links over the run: mean utilization, contended
        time, and per-stage-class byte share (the generalized
        ``sample_contention``)."""
        span = max(self._t_end - (self._t0 or 0.0), 1e-12)
        out = []
        for lid, bt in self.link_byte_time.items():
            total = sum(v for (l, _), v in self.link_stage_bytes.items()
                        if l == lid)
            shares = {st: v / total
                      for (l, st), v in sorted(self.link_stage_bytes.items())
                      if l == lid and total > 0}
            out.append({
                "link": lid, "link_name": link_name(self.topo, lid),
                "mean_util": bt / (self.topo.capacity[lid] * span),
                "contended_s": self.link_contended_time.get(lid, 0.0),
                "stage_share": shares})
        out.sort(key=lambda d: -d["contended_s"] or -d["mean_util"])
        return out[:top]

    def contended_stage_share(self) -> Dict[str, float]:
        """Per-stage share of bytes moved over contended link-seconds —
        the cross-plane generalization of ``KVStore.wb_share_contended``."""
        total = sum(self.contended_stage_bytes.values())
        if total <= 0:
            return {}
        agg: Dict[str, float] = {}
        for (_, st), v in self.contended_stage_bytes.items():
            agg[st] = agg.get(st, 0.0) + v
        return {st: v / total for st, v in sorted(agg.items())}

    # --------------------------------------------------------------- export
    def to_chrome_trace(self, rids: Optional[Set[int]] = None) -> Dict:
        """Chrome/Perfetto trace-event JSON (``ph: X`` complete events over
        µs timestamps). Lanes: one pid per serving unit for compute spans,
        pid 10_000 + src node for network flow spans (tid = stage), async
        ``b``/``e`` pairs per request lifetime. ``rids`` filters to a
        request subset (e.g. one missed request's timeline)."""
        ev: List[Dict[str, Any]] = []
        us = 1e6

        def keep(rid: int) -> bool:
            return rids is None or rid in rids

        for (unit, bid, g, c, t0, t1) in self.compute_spans:
            bids = {self.requests[r].batch for r in (rids or ())
                    if r in self.requests} if rids is not None else None
            if bids is not None and bid not in bids:
                continue
            ev.append({"name": f"compute b{bid} g{g}c{c}", "cat": "compute",
                       "ph": "X", "ts": t0 * us, "dur": (t1 - t0) * us,
                       "pid": unit, "tid": 0,
                       "args": {"bid": bid, "group": g, "chunk": c}})
        for sp in self.flow_spans.values():
            if not keep(sp.rid) or sp.finished is None:
                continue
            ev.append({
                "name": f"{sp.stage.name} r{sp.rid} g{sp.group}",
                "cat": f"net.{sp.stage.name}", "ph": "X",
                "ts": sp.created * us, "dur": max(sp.duration, 0.0) * us,
                "pid": 10_000 + max(sp.src, 0), "tid": int(sp.stage),
                "args": {"rid": sp.rid, "bytes": sp.size,
                         "end_state": sp.end_state,
                         "level0": sp.level0, "level": sp.level_final,
                         "idle_s": sp.idle, "xfer_s": sp.xfer,
                         "max_rate": sp.max_rate,
                         "rate_changes": sp.rate_changes,
                         "bottleneck": sp.bottleneck,
                         "bottleneck_name":
                             link_name(self.topo, sp.bottleneck)
                             if sp.bottleneck >= 0 else None,
                         "deadline": sp.deadline}})
        for rid, tr in self.requests.items():
            if not keep(rid):
                continue
            t_end = None
            if tr.ttft is not None:
                t_end = tr.arrival + tr.ttft
            elif tr.events:
                t_end = tr.events[-1][0]
            if t_end is None:
                continue
            common = {"cat": "request", "id": rid, "pid": 20_000,
                      "tid": max(tr.unit, 0)}
            ev.append(dict(common, name=f"request r{rid}", ph="b",
                           ts=tr.arrival * us,
                           args={"slo_class": tr.slo_class,
                                 "status": tr.status}))
            ev.append(dict(common, name=f"request r{rid}", ph="e",
                           ts=t_end * us, args={"ttft": tr.ttft}))
            for (t, kind, arg) in tr.events:
                ev.append({"name": kind, "cat": "lifecycle", "ph": "i",
                           "ts": t * us, "pid": 20_000,
                           "tid": max(tr.unit, 0), "s": "t",
                           "args": {"rid": rid, "detail": arg}})
        for pid, name in ((20_000, "requests"),):
            ev.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "ts": 0,
                       "args": {"name": name}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str,
                          rids: Optional[Set[int]] = None) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(rids), fh)

    # --------------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        served = sum(1 for t in self.requests.values()
                     if t.status == "served")
        return {
            "requests": len(self.requests), "served": served,
            "flow_spans": len(self.flow_spans),
            "open_spans": sum(1 for s in self.flow_spans.values()
                              if s.end_state == "open"),
            "compute_spans": len(self.compute_spans),
            "audit_events": len(self.audit),
            "links_sampled": len(self.link_byte_time),
            "dropped": dict(self.dropped),
        }
