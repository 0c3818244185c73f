"""MsFlow runtime — the shared orchestration core of §5.

One event-loop driver used by BOTH the cluster simulator
(``repro.simcluster.sim.ClusterSim``) and the real-JAX serving path
(``repro.serving.disagg.DisaggServer``). Every transfer goes through the
standardized primitives

    submit(flow-with-metadata)  ->  fid
    permit(fid, priority)           (the policy's assign() on the RMLQ)
    completion(fid)                 (fires the dependent continuation)

with the pluggable policy deciding priorities and ``repro.netsim.FluidNet``
playing the fabric. Computation events and network events share one
``EventQueue`` (§6.1: "processed within a single event queue").

Per batch and super-layer g a unit: (wait for Stage-1 flows targeting
groups <= g) -> compute C_g -> emit Stage-3 P2D flows for g (+ Stage-2
coflow, which must finish before group g+1 computes). Reused prefix tokens
skip computation but their KV must arrive (Stage 1) before the consuming
layer group runs — late arrivals stall the GPU, which is precisely the
contention -> TTFT coupling the paper measures.

With a :class:`repro.core.decode.DecodePlane` attached, requests live past
their first token: ``dstep`` compute events advance per-endpoint decode
batches on the same queue, and the plane's rebalancer submits Stage-D2D
KV-migration flows through the same ``_submit`` primitive, contending with
S1/S2/S3 in the shared fluid net.

Request placement is a runtime concern, not a host concern: every arrival
runs the pluggable **router plane** (``repro.core.router``) — the
configured :class:`~repro.core.router.RouterPolicy` picks the prefill
unit through a :class:`~repro.core.router.RoutingView`, the KV-reuse hit
resolves against the live store for the chosen unit, and an optional
:class:`~repro.core.router.AdmissionController` may shed or defer
loose-SLO requests while its overload detector is tripped. Hosts
customise the runtime through :class:`RuntimeHost` hooks only — supplying
state the router reads (``prepare_route`` fills the legacy reuse oracle,
``kv_chain_keys`` exposes store keys), admission/completion bookkeeping,
and — on the serving path — launching the *real* JAX prefill when a batch
starts. The full MFS policy surface (RMLQ promotion, Algorithm 1 RED
ordering + feasibility pruning, scavenger readmission) runs identically
on both hosts; there are no degenerate per-host stubs.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .arbiter import MFSScheduler
from .feasibility import BatchLoad, inter_request_schedule
from .monitor import Monitor, ProbeFanout
from .msflow import Coflow, Flow, FlowState, Stage
from .policies import Policy
from .router import (AdmissionController, KVAffinityRouter, RouterPolicy,
                     RoutingView)
from .stages import (BatchState, ChunkPlan, PrefillItem, StageEmitter,
                     StageProfile)
from .telemetry import StageLog, Telemetry

__all__ = ["RuntimeHost", "MsFlowRuntime", "RuntimeView"]


class RuntimeHost:
    """Hooks a host implements around the shared runtime (all optional).
    The runtime never reaches into host state directly — and since the
    router plane, hosts no longer place requests: the runtime calls the
    configured :class:`~repro.core.router.RouterPolicy`; hosts only supply
    the state it reads."""

    def prepare_route(self, item: PrefillItem) -> None:
        """Called once per arrival BEFORE the router places the request.
        Hosts refresh whatever placement state lives on the item here —
        the serving path matches its prefix index and fills the legacy
        ``(reuse, owner_unit)`` oracle (``owner_unit = -1`` when no owner
        exists); the simulator's trace items arrive pre-filled. With a KV
        store attached the oracle is ignored: the runtime resolves the hit
        against live store state after placement."""

    def on_admitted(self, item: PrefillItem) -> None:
        """Called once per request after routing + deadline derivation."""

    def on_shed(self, item: PrefillItem) -> None:
        """Called when admission control rejects the request (overload +
        sheddable SLO class). The request never enters a queue, holds no
        store pins and no decode slots; hosts record the outcome (an SLO
        miss against all-arrivals attainment)."""

    def on_deferred(self, item: PrefillItem) -> None:
        """Called each time admission control delays the request; it will
        re-arrive after the configured delay on its ORIGINAL arrival clock
        (deadline unchanged — the SLO budget keeps burning)."""

    def on_batch_started(self, bs: BatchState) -> None:
        """Called when a batch forms — the serving host runs the real JAX
        prefill here (results are exact; latency comes from the profile)."""

    def on_request_done(self, item: PrefillItem, bs: BatchState) -> None:
        """Called when a request's TTFT materialises (last P2D arrived)."""

    def on_coflow_done(self, bs: BatchState, co: Coflow, ideal: float) -> None:
        """Called when a Stage-2 coflow completes (CCT bookkeeping)."""

    def on_decode_admitted(self, sess) -> None:
        """Called when a request enters the decode plane (TTFT materialised
        and a ``DecodePlane`` is attached)."""

    def on_decode_done(self, sess) -> None:
        """Called when a decode session produces its last token (TPOT/TBT
        metrics are final on ``sess``)."""

    def kv_chain_keys(self, item: PrefillItem) -> Tuple:
        """Block-key chain of the request's reusable prefix (the same keys
        the host's ``route()`` resolves against the KV store), used by
        fixed-mode SLO calibration to estimate steady-state hit rates. An
        empty tuple means "no reusable prefix"."""
        return ()


class RuntimeView:
    """The one concrete SchedView over FluidNet + runtime state."""

    def __init__(self, rt: "MsFlowRuntime"):
        self.rt = rt

    @property
    def now(self) -> float:
        return self.rt.net.now

    def bottleneck(self, flow: Flow) -> Tuple[float, float]:
        return self.rt.net.bottleneck(flow)

    def mlu_inputs(self, flow: Flow, level: int) -> Tuple[float, float]:
        # Protected = traffic strictly more urgent than this flow would be at
        # ``level``: anything at a higher level, plus early-stage flows at the
        # same level (band precedence, §4.5). Early-stage flows at *lower*
        # levels would be preempted by the promotion, so they don't raise rho.
        def protected(other: Flow) -> bool:
            k = other.priority_key
            return k[0] < level or (k[0] == level and len(k) >= 2 and k[1] == 0)
        return self.rt.net.bottleneck_protected(flow, protected)

    def l_curr(self, unit: int) -> int:
        b = self.rt.active_batch.get(unit)
        return b.cur_group if b else 0

    def computing(self, rid: int) -> bool:
        b = self.rt.batch_of_request.get(rid)
        return bool(b and b.compute_done_at is None)

    def red_rank(self, rid: int) -> int:
        return self.rt.red_ranks.get(rid, 0)

    def downstream_estimate(self, flow: Flow) -> float:
        """Time until the data carried by ``flow`` is actually consumed.

        With chunked prefill the current group's contribution tightens from
        its full compute time to the *remaining chunks* only — policies see
        sharper laxity as the chunk front advances, so MFS promotion fires
        earlier for long prompts (monotonically ≤ the group-granular
        estimate; chunk off reproduces it exactly)."""
        b = self.rt.batch_of_request.get(flow.rid)
        if b is None or b.compute_done_at is not None:
            return 0.0
        if flow.stage == Stage.COLLECTIVE:
            return 0.0                      # blocks the very next step
        if b.chunk_plan is None:
            if flow.stage == Stage.KV_REUSE:   # needed when its group starts
                return sum(b.group_time[b.cur_group:flow.target_layer])
            rem = len(b.group_time) - b.cur_group
            return sum(b.group_time[b.cur_group:]) + b.recompute_extra * rem
        rem_cur = sum(b.chunk_time[b.cur_group][b.cur_chunk:])
        if flow.stage == Stage.KV_REUSE:    # needed when its group starts
            if flow.target_layer <= b.cur_group:
                return 0.0
            return rem_cur + sum(b.group_time[b.cur_group + 1:flow.target_layer])
        rem = len(b.group_time) - b.cur_group
        return rem_cur + sum(b.group_time[b.cur_group + 1:]) \
            + b.recompute_extra * rem


class MsFlowRuntime:
    """Event-loop driver + batch lifecycle + overload control (Algorithm 1)."""

    def __init__(self, topo, net, evq, policy: Policy, profile: StageProfile,
                 emitter: StageEmitter, host: RuntimeHost, n_units: int, *,
                 max_batch_tokens: int = 8192, slo_scale: float = 3.0,
                 slo_mode: str = "per-request", tick_interval: float = 2e-3,
                 drop_budget: int = 32, contention_free: bool = False,
                 trace_stages: bool = False, stage_log_limit: int = 100_000,
                 decode=None, kvstore=None,
                 router: Optional[RouterPolicy] = None,
                 admission: Optional[AdmissionController] = None,
                 telemetry: Optional[Telemetry] = None,
                 monitor: Optional[Monitor] = None):
        self.topo = topo
        self.net = net
        self.evq = evq
        self.policy = policy
        self.profile = profile
        self.emitter = emitter
        self.host = host
        self.n_units = n_units
        self.max_batch_tokens = max_batch_tokens
        self.slo_scale = slo_scale
        self.slo_mode = slo_mode                 # "per-request" | "fixed"
        self.tick_interval = tick_interval
        self.drop_budget = drop_budget
        self.contention_free = contention_free
        #: optional DecodePlane — requests live past their first token,
        #: D2D rebalancing flows share the net with S1/S2/S3
        self.decode = decode
        if decode is not None:
            decode.bind(self)
        #: optional KV-reuse plane (repro.core.kvstore.KVStore) — admission
        #: on prefill completion emits Stage-WB writeback flows through the
        #: same _submit primitive, contending with S1/S2/S3/D2D
        self.kvstore = kvstore
        #: chunked prefill (Sarathi-style): > 0 splits every super-layer
        #: group's compute into token-budgeted chunks with per-chunk
        #: S1/S2/S3 emission; 0 is the legacy group-granular schedule.
        #: The emitter owns the knob — runtime chunk plans and per-chunk
        #: recompute accounting must match the emitted flow granularity,
        #: so there is exactly one source of truth.
        self.chunk_tokens = getattr(emitter, "chunk_tokens", 0)
        self.view = RuntimeView(self)
        #: router plane — the runtime owns placement; the default policy is
        #: the extracted historical rule (hit-weighted affinity vs backlog),
        #: bit-identical to the pre-plane per-host loops
        self.router = router if router is not None else KVAffinityRouter()
        #: optional admission-control stage (None = admit everything, the
        #: legacy behaviour)
        self.admission = admission
        self.routing_view = RoutingView(self)
        self.n_shed = 0
        self.n_deferred = 0

        # --- per-unit serving state ---
        self.queues: List[Deque[PrefillItem]] = [deque() for _ in range(n_units)]
        self.active_batch: Dict[int, BatchState] = {}
        self.batch_of_request: Dict[int, BatchState] = {}
        self.backlog_tokens = [0.0] * n_units
        self._bid = itertools.count()

        # --- scheduler state (O(active), not O(history): completed flows
        # and finished requests are evicted so long traces stay bounded) ---
        self.flows: Dict[int, Flow] = {}
        self.red_ranks: Dict[int, int] = {}
        self.pruned_rids: Set[int] = set()     # currently demoted
        self.ever_pruned: Set[int] = set()     # paid a prune (<= drop budget)
        self.n_pruned = 0
        self.n_red_runs = 0                    # Algorithm 1 invocations
        self._epoch = 0
        self._slo_base: Optional[float] = None  # fixed-mode low-load mean TTFT
        self._tick_armed = False
        self._G = len(profile.plan)
        self._t_first_decode = profile.first_decode_time()
        # optional observability: (rid, stage, group, size, deadline) per
        # submitted flow, consumed by the parity tests and the reports of
        # examples/serve_disagg.py; bounded so tracing cannot grow O(history)
        # — StageLog counts (and warns about) rows the bound drops
        self.trace_stages = trace_stages
        self.stage_log: StageLog = StageLog(maxlen=stage_log_limit)
        self.submit_level: Dict[int, int] = {}   # live flows only
        self._promoted: Dict[Stage, int] = {}    # evicted flows' promotions
        #: telemetry plane (repro.core.telemetry) — None keeps every probe
        #: site a single falsy check; the collector is a pure observer, so
        #: enabling it never changes scheduling outcomes
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.bind(lambda: self.net.now, topo,
                           t_first_decode=self._t_first_decode)
            if isinstance(policy, MFSScheduler):
                policy.attach_telemetry(telemetry)
        #: online monitor plane (repro.core.monitor) — streaming estimators
        #: over the SAME probe surface; like telemetry, a pure observer, and
        #: its SignalBus feeds detectors/routers the bit-identical values
        #: they used to compute in-line
        self.monitor = monitor
        if monitor is not None:
            monitor.bind(lambda: self.net.now, topo,
                         t_first_decode=self._t_first_decode)
            monitor.bind_live(self.routing_view)
            self.router.attach_bus(monitor.bus)
            if self.admission is not None:
                self.admission.detector.attach_bus(monitor.bus)
        #: single probe target — telemetry, monitor, a fanout over both, or
        #: None; every probe site stays ONE falsy check
        if telemetry is not None and monitor is not None:
            self._probe = ProbeFanout(telemetry, monitor)
        else:
            self._probe = telemetry if telemetry is not None else monitor

    # ---------------------------------------------------------- calibration
    def calibrate_slo(self, items: Sequence[PrefillItem]) -> None:
        """§6.1: one workload-level SLO base = the mean low-load TTFT
        (``slo_mode="fixed"``); each request's budget is its own
        ``slo_scale`` (tight/standard/loose class, falling back to the
        cluster default) times that base. Per-request mode derives each
        deadline from the request's own ideal at admission time instead.

        **Store-aware calibration**: with a KV-reuse plane attached, actual
        reuse comes from live store residency — not the trace's pre-sampled
        ``reuse_len`` — so the base is derived from the *expected
        steady-state hit* of each request's chain (a capacity-bounded LRU
        replay, :meth:`KVStore.steady_state_reuse`). Store-on and store-off
        attainment then measure scheduling against the same notion of
        achievable low-load TTFT instead of penalising store-on cold
        starts. Store-off keeps the legacy pre-sampled-reuse base
        bit-for-bit."""
        if self.slo_mode == "fixed" and items:
            if self.kvstore is not None:
                entries = [(self.host.kv_chain_keys(it),
                            max(0, it.n_tokens - 1)) for it in items]
                expected = self.kvstore.steady_state_reuse(entries)
                self._slo_base = float(np.mean([
                    self.profile.ideal_ttft(PrefillItem(
                        rid=-1, arrival=0.0, n_tokens=it.n_tokens,
                        reuse=min(exp, max(0, it.n_tokens - 1))))
                    for it, exp in zip(items, expected)]))
            else:
                self._slo_base = float(np.mean([self.profile.ideal_ttft(i)
                                                for i in items]))
        else:
            self._slo_base = None

    # ------------------------------------------------------------- plumbing
    def push_arrival(self, item: PrefillItem) -> None:
        self.evq.push(item.arrival, "arr", item)

    def _submit(self, flow: Flow) -> None:
        flow.created = self.net.now
        self.flows[flow.fid] = flow
        self.net.add(flow)
        if flow.rid in self.pruned_rids and flow.stage != Stage.COLLECTIVE:
            flow.state = FlowState.PRUNED
        self.policy.on_flow_submitted(flow, self.view)
        self.submit_level[flow.fid] = flow.level
        if self._probe is not None:
            # with telemetry/monitor on, the legacy stage log is backed by
            # the same probe (one append site, identical rows)
            self._probe.flow_submitted(
                flow, self.stage_log if self.trace_stages else None)
        elif self.trace_stages:
            self.stage_log.append((flow.rid, flow.stage, flow.target_layer,
                                   flow.size, flow.deadline))

    def _resched(self, trigger: Tuple = ("event",)) -> None:
        active = list(self.net.flows.values())
        self.policy.assign(active, self.view, trigger)
        if self.contention_free:
            for f in active:
                route = self.net.routes[f.fid]
                self.net.set_rate(f, min((self.topo.capacity[l] for l in route),
                                         default=2e12))
            self.net._link_rate = {}
        else:
            self.net.reallocate()
        self._epoch += 1
        nxt = self.net.next_completion()
        if nxt is not None:
            self.evq.push(nxt[0], "net", None, epoch=self._epoch)

    # ---------------------------------------------------------- unit driver
    def _maybe_start_batch(self, u: int) -> None:
        if u in self.active_batch or not self.queues[u]:
            return
        batch: List[PrefillItem] = []
        tokens = 0
        while self.queues[u]:
            it = self.queues[u][0]
            if batch and tokens + it.n_tokens > self.max_batch_tokens:
                break
            batch.append(self.queues[u].popleft())
            tokens += it.n_tokens
        bs = BatchState(
            bid=next(self._bid), unit=u, items=batch,
            group_time=[self.profile.group_compute_time(batch, g)
                        for g in range(self._G)],
            started=self.net.now)
        if self.chunk_tokens > 0:
            bs.chunk_plan = ChunkPlan.build(batch, self.chunk_tokens)
            bs.chunk_time = [
                [self.profile.chunk_compute_time(batch, bs.chunk_plan, g, c)
                 for c in range(bs.chunk_plan.n_chunks)]
                for g in range(self._G)]
        self.active_batch[u] = bs
        for it in batch:
            self.batch_of_request[it.rid] = bs
            bs.p2d_pending[it.rid] = set()
        self.host.on_batch_started(bs)
        if self._probe is not None:
            self._probe.on_batch_started(bs)
        for f in self.emitter.stage1(bs):
            self._submit(f)
        if self.policy.uses_inter_request:
            self._run_inter_request()
        self._try_start_group(bs)
        self._resched(("submit",))

    def _try_start_group(self, bs: BatchState) -> None:
        """Start the next cell of the (group, chunk) grid. Stage-1 gates
        only a group's FIRST chunk (causal attention needs the whole reused
        prefix before the group's first new token; later chunks depend on
        the previous chunk's collective instead); without a chunk plan the
        grid's chunk axis has length 1 and this is the legacy group walk."""
        g, c = bs.cur_group, bs.cur_chunk
        blocking = set()
        if c == 0:
            for gg in range(g + 1):
                for fid in bs.s1_pending.get(gg, ()):  # still outstanding
                    fl = self.flows[fid]
                    # scavenged (pruned) Stage-1 flows do NOT block the batch:
                    # their reuse is abandoned and recomputed instead (§5:
                    # "requests can be pruned ... to suppress communication")
                    if fl.state not in (FlowState.DONE, FlowState.PRUNED):
                        blocking.add(fid)
        if blocking:
            bs.phase = "wait_s1"
            if bs.stall_begin is None:
                bs.stall_begin = self.net.now
            return
        if bs.stall_begin is not None:
            dt = self.net.now - bs.stall_begin
            for it in bs.items:
                it.stalls += dt
            bs.stall_begin = None
        bs.phase = "compute"
        if bs.chunk_plan is None:
            dur = bs.group_time[g] + self._recompute_penalty(bs, g)
        else:
            dur = bs.chunk_time[g][c] \
                + (self._recompute_penalty(bs, g) if c == 0 else 0.0)
        if self._probe is not None:
            self._probe.compute_open(bs, g, c)
        self.evq.push(self.net.now + dur, "compute", (bs.bid, bs.unit, g, c))

    def _recompute_penalty(self, bs: BatchState, g: int) -> float:
        """Compute time to re-derive reused KV that pruning left undelivered.

        Charged once per (request, group), proportional to the undelivered
        fraction; the stale flow is cancelled to free its bandwidth."""
        extra = 0.0
        for gg in range(g + 1):
            for fid in list(bs.s1_pending.get(gg, ())):
                fl = self.flows[fid]
                if fl.state != FlowState.PRUNED or fl.remaining <= 0:
                    continue
                if (fl.rid, gg) in bs.recomputed:
                    continue
                it = next(i for i in bs.items if i.rid == fl.rid)
                if self.chunk_tokens > 0:
                    # chunked S1: the group's fetch is many chunk flows, so
                    # the (rid, group) is NOT marked done — each pruned
                    # chunk pays for ITS undelivered bytes relative to the
                    # request's whole group fetch (fractions over the
                    # group's chunk flows sum to the undelivered share;
                    # delivered chunks are never recomputed)
                    total = it.reuse * self.profile.kv_bytes_group(gg)
                    frac = fl.remaining / max(total, 1e-9)
                else:
                    bs.recomputed.add((fl.rid, gg))
                    frac = fl.remaining / max(fl.size, 1e-9)
                extra += self.profile.recompute_time(it.reuse, frac, gg)
                bs.s1_pending[gg].discard(fid)
                if fid in self.net.flows:
                    self.net.remove(fl)
                self.policy.on_flow_completed(fl, self.view)
                self._evict_flow(fl)
        return extra

    # ----------------------------------------------------------- state GC
    def _evict_flow(self, f: Flow) -> None:
        """Drop a finished/cancelled flow from runtime state, folding its
        promotion outcome into the compact per-stage counters first."""
        if self._probe is not None:
            self._probe.flow_closed(f, self.net)
        self.flows.pop(f.fid, None)
        lvl0 = self.submit_level.pop(f.fid, None)
        if lvl0 is not None and f.level < lvl0:
            self._promoted[f.stage] = self._promoted.get(f.stage, 0) + 1

    def promoted_count(self, stage: Optional[Stage] = None) -> int:
        """Flows promoted below their submission level (evicted + live)."""
        n = sum(v for s, v in self._promoted.items()
                if stage is None or s == stage)
        for fid, lvl0 in self.submit_level.items():
            f = self.flows.get(fid)
            if f is not None and (stage is None or f.stage == stage) \
                    and f.level < lvl0:
                n += 1
        return n

    # --------------------------------------------------------- event handlers
    def _on_arrival(self, item: PrefillItem) -> None:
        # Router plane: the host refreshes placement state (prefix-index
        # match / legacy reuse oracle), the configured policy places, and —
        # with a KV store attached — the winner's hit resolves against live
        # store state (pins + LRU touches happen for the chosen unit ONLY,
        # exactly the old kv_route order: read-only peek, then one resolve).
        self.host.prepare_route(item)
        u = self.router.place(item, self.routing_view)
        if self.kvstore is not None:
            keys = self.host.kv_chain_keys(item)
            plan = self.kvstore.resolve(keys, max(0, item.n_tokens - 1), u,
                                        item.rid, now=self.net.now)
            item.reuse = plan.tokens
            item.hit_plan = plan
            item.owner_unit = u
        if item.owner_unit < 0:
            item.owner_unit = u             # no-owner sentinel: self-owned
        item.unit = u
        if self._probe is not None:
            self._probe.on_arrival(item, u)
        if self.decode is not None and not item.pool:
            item.pool = self.decode.pick_pool(item)
        item.ideal_ttft = self.profile.ideal_ttft(item)
        # per-request SLO class (tight/standard/loose) scales either the
        # workload-level base (fixed mode) or the request's own ideal;
        # classless requests fall back to the pool default (P2D deadlines
        # differ per pool), then the cluster-wide default
        scale = item.slo_scale
        if scale <= 0 and self.decode is not None:
            scale = self.decode.pool_slo_scale(item.pool)
        if scale <= 0:
            scale = self.slo_scale
        if self.slo_mode == "fixed" and self._slo_base is not None:
            item.deadline = item.arrival + scale * self._slo_base
        else:
            item.deadline = item.arrival + scale * item.ideal_ttft
        # Admission stage: while the overload detector is tripped, sheddable
        # requests are rejected or delayed BEFORE they hold any resources —
        # the resolve above pinned store blocks for the hit, so both paths
        # must release them (re-resolved on a deferred retry).
        if self.admission is not None:
            verdict = self.admission.decide(item, self.routing_view, u)
            if verdict != "admit":
                if self.kvstore is not None:
                    self.kvstore.release(item.rid)
                    item.reuse, item.hit_plan = 0, None
                if verdict == "defer":
                    item.deferrals += 1
                    self.n_deferred += 1
                    self.host.on_deferred(item)
                    if self._probe is not None:
                        self._probe.on_deferred(item)
                    self.evq.push(self.net.now + self.admission.spec.defer_delay,
                                  "arr", item)
                else:
                    self.n_shed += 1
                    self.host.on_shed(item)
                    if self._probe is not None:
                        self._probe.on_shed(item)
                return
        self.queues[u].append(item)
        self.backlog_tokens[u] += item.n_tokens
        self.host.on_admitted(item)
        if self._probe is not None:
            self._probe.on_admitted(item)
        self._maybe_start_batch(u)

    def _on_compute_done(self, bid: int, unit: int, g: int, c: int = 0) -> None:
        bs = self.active_batch.get(unit)
        if bs is None or bs.bid != bid or bs.cur_group != g \
                or bs.cur_chunk != c or bs.phase != "compute":
            return   # stale
        if self._probe is not None:
            self._probe.compute_close(unit)
        if bs.chunk_plan is None:
            for f in self.emitter.stage3(bs, g, self._t_first_decode):
                self._submit(f)
            co = self.emitter.stage2(bs)
        else:
            # chunked prefill: the chunk's P2D leaves NOW, overlapping the
            # next chunk's compute; the chunk's collective gates that compute
            for f in self.emitter.stage3_chunk(bs, g, c, self._t_first_decode):
                self._submit(f)
            co = self.emitter.stage2_chunk(bs, g, c)
        if co is not None:
            co.started = self.net.now
            for fl in co.flows:
                self._submit(fl)
            bs.coll = co
            bs.coll_started = self.net.now
            bs.phase = "wait_coll"
            self._resched(("layer", unit))
            return
        self._advance_group(bs)
        self._resched(("layer", unit))

    def _advance_group(self, bs: BatchState) -> None:
        if bs.chunk_plan is not None \
                and bs.cur_chunk + 1 < bs.chunk_plan.n_chunks:
            bs.cur_chunk += 1            # next cell of the chunk grid
            bs.coll = None
            self._try_start_group(bs)
            return
        bs.cur_chunk = 0
        bs.cur_group += 1
        bs.coll = None
        if bs.cur_group >= self._G:
            bs.compute_done_at = self.net.now
            for it in bs.items:
                it.prefill_done = self.net.now
                self._maybe_finish_request(it, bs)
            bs.phase = "drain"
            del self.active_batch[bs.unit]
            self.backlog_tokens[bs.unit] = max(
                0.0, self.backlog_tokens[bs.unit] - bs.tokens)
            self._arm_tick()
            if self.policy.uses_inter_request:
                self._run_inter_request()
            self._maybe_start_batch(bs.unit)
        else:
            self._try_start_group(bs)

    def _maybe_finish_request(self, item: PrefillItem, bs: BatchState) -> None:
        if item.ttft is not None or item.prefill_done is None:
            return
        # Completion requires every *actually emitted* P2D flow to be done.
        # (Counting groups instead would deadlock requests whose KV-light
        # groups emitted no flow at all.) prefill_done is only set after the
        # last group ran, so the emitted set is final here. ``p2d_pending``
        # holds the still-outstanding fids (done flows are discarded as they
        # complete, with the latest finish time folded into ``p2d_last``) so
        # this check never needs the evicted flow records.
        if bs.p2d_pending.get(item.rid):
            return
        last = bs.p2d_last.get(item.rid, item.prefill_done)
        item.ttft = max(item.prefill_done, last) - item.arrival \
            + self._t_first_decode
        self.batch_of_request.pop(item.rid, None)
        self.red_ranks.pop(item.rid, None)
        self.pruned_rids.discard(item.rid)
        self.host.on_request_done(item, bs)
        if self._probe is not None:
            self._probe.on_request_done(item, bs)
        if self.kvstore is not None:
            # KV-reuse plane admission: the chain's blocks are registered in
            # the origin tier and loose-deadline Stage-WB replication flows
            # enter the shared net. Hit pins are released here unless a
            # decode plane holds the session live past its first token —
            # then the plane releases them on session finish/eviction.
            wbs = self.kvstore.admit(item, self.net.now,
                                     keep_pins=self.decode is not None)
            for f in wbs:
                self._submit(f)
            if wbs:
                self._resched(("submit",))
                self._arm_tick()
        if self.decode is not None:
            if self.decode.admit(item, self.net.now):
                self._resched(("submit",))   # admission triggered D2D flows
                self._arm_tick()

    def _on_flow_done(self, f: Flow) -> None:
        self.policy.on_flow_completed(f, self.view)
        if f.stage == Stage.WB:
            if self.kvstore is not None:
                # blocks land in the target tier; popularity-driven hot-block
                # replication may push follow-on WB flows toward more units
                wbs = self.kvstore.on_wb_done(f)
                for w in wbs or ():
                    self._submit(w)
                if wbs:
                    self._resched(("submit",))
                    self._arm_tick()
            self._evict_flow(f)
            return
        if f.stage == Stage.D2D:
            if self.decode is not None \
                    and self.decode.on_d2d_done(f, self.net.now):
                self._resched(("submit",))   # follow-up migrations submitted
            self._evict_flow(f)
            return
        bs = self.batch_of_request.get(f.rid)
        if f.stage == Stage.KV_REUSE:
            if bs is not None:
                bs.s1_pending.get(f.target_layer, set()).discard(f.fid)
                if bs.phase == "wait_s1":
                    self._try_start_group(bs)
        elif f.stage == Stage.COLLECTIVE:
            if bs is not None and bs.coll is not None and f.coflow == bs.coll.cid:
                if bs.coll.done():
                    bs.coll.finished = self.net.now
                    if self._probe is not None:
                        self._probe.coll_wait(
                            bs.bid, self.net.now - bs.coll_started)
                    co = bs.coll
                    self.host.on_coflow_done(bs, co, self._coflow_ideal(co))
                    if bs.phase == "wait_coll":
                        self._advance_group(bs)
        else:  # P2D
            if bs is not None:
                pend = bs.p2d_pending.get(f.rid)
                if pend is not None:
                    pend.discard(f.fid)
                    if f.finished is not None:
                        bs.p2d_last[f.rid] = max(
                            bs.p2d_last.get(f.rid, 0.0), f.finished)
                self._maybe_finish_request(
                    next(i for i in bs.items if i.rid == f.rid), bs)
        self._evict_flow(f)

    def _coflow_ideal(self, co: Coflow) -> float:
        worst = 0.0
        for f in co.flows:
            route = self.topo.route(f.src, f.dst, f.fid)
            cap = min((self.topo.capacity[l] for l in route), default=2e12)
            worst = max(worst, f.size / cap)
        return worst

    def _arm_tick(self) -> None:
        if not self._tick_armed:
            self._tick_armed = True
            self.evq.push(self.net.now + self.tick_interval, "tick", None)

    def _on_tick(self) -> None:
        self._tick_armed = False
        if self.kvstore is not None:
            # contended-link class accounting (WB share vs P2D/D2D/S1);
            # credit at most two tick pitches so idle gaps between bursts
            # are never attributed to the resuming traffic
            self.kvstore.sample_contention(self.net, self.net.now,
                                           max_dt=2 * self.tick_interval)
        if self.decode is not None and self.decode.auto_evict_enabled():
            # decode-side Algorithm-1 loop: abandon migrations whose derived
            # deadline went infeasible (spill/evict per class) — may cancel
            # and submit flows, so the allocation must refresh
            if self.decode.auto_evict(self.net.now):
                self._resched(("tick",))
        # post-compute P2D flows, in-flight D2D migrations and KV-store
        # writebacks all re-evaluate their MLU level on the periodic tick
        # (no layer boundaries to ride)
        post = [f for f in self.net.flows.values()
                if (f.stage == Stage.P2D and not self.view.computing(f.rid))
                or f.stage in (Stage.D2D, Stage.WB)]
        if post:
            self._resched(("tick",))
            self._arm_tick()

    # ------------------------------------------------- Algorithm 1 coupling
    def _run_inter_request(self) -> None:
        batches: List[BatchLoad] = []
        n_ports = 2 * self.topo.n_nodes       # NIC up/down links
        for bs in self.active_batch.values():
            loads: Dict[int, np.ndarray] = {}
            deadlines: Dict[int, float] = {}
            for it in bs.items:
                v = np.zeros(n_ports)
                for fid_set in list(bs.s1_pending.values()):
                    for fid in fid_set:
                        # pending sets hold live (outstanding/pruned) fids only
                        fl = self.flows.get(fid)
                        if fl is None or fl.rid != it.rid:
                            continue
                        for lid in self.topo.route(fl.src, fl.dst, fl.fid):
                            if lid < n_ports:
                                v[lid] += fl.remaining
                rem_kv = it.n_tokens * sum(
                    self.profile.kv_bytes_group(g)
                    for g in range(bs.cur_group, self._G))
                ep = self.emitter.rank_endpoint(bs, it, bs.cur_group)
                v[2 * ep] += rem_kv           # future P2D leaves via this NIC
                loads[it.rid] = v
                deadlines[it.rid] = it.deadline
            rem_groups = len(bs.group_time) - bs.cur_group
            if bs.chunk_plan is None:
                comp = sum(bs.group_time[bs.cur_group:]) \
                    + bs.recompute_extra * rem_groups
            else:       # chunk-aware: only the current group's REMAINING
                comp = sum(bs.chunk_time[bs.cur_group][bs.cur_chunk:]) \
                    + sum(bs.group_time[bs.cur_group + 1:]) \
                    + bs.recompute_extra * rem_groups
            batches.append(BatchLoad(bs.bid, loads, deadlines, comp))
        if not batches:
            return
        self.n_red_runs += 1
        port_bw = np.array([self.topo.capacity[l] for l in range(n_ports)])
        # Algorithm 1 takes a GLOBAL total drop budget; spend it across the
        # whole run so overload control cannot death-spiral the cluster.
        budget_left = max(0, self.drop_budget - self.n_pruned)
        sched = inter_request_schedule(batches, port_bw, now=self.net.now,
                                       drop_budget=budget_left)
        rank_of_batch = {bid: i for i, bid in enumerate(sched.order)}
        newly_pruned = {rid for (_, rid) in sched.pruned}
        if self._probe is not None:
            self._probe.red_run(sched.order, newly_pruned, len(batches))
        for bs in self.active_batch.values():
            for it in bs.items:
                self.red_ranks[it.rid] = rank_of_batch.get(bs.bid, 0)
        # soft enforcement: demote pruned requests' flows, abandon their reuse
        for bs in self.active_batch.values():
            for it in bs.items:
                if it.rid in newly_pruned and it.rid not in self.pruned_rids:
                    self.pruned_rids.add(it.rid)
                    self.ever_pruned.add(it.rid)
                    self.n_pruned += 1
                    if self._probe is not None:
                        self._probe.on_pruned(it.rid)
                    self._apply_prune(bs, it)
        # re-admission: requests no longer in the pruned set
        for rid in list(self.pruned_rids):
            if rid not in newly_pruned and rid in self.batch_of_request:
                self.pruned_rids.discard(rid)
                if self._probe is not None:
                    self._probe.on_readmitted(rid)
                for f in self.net.flows.values():
                    if f.rid == rid and f.state == FlowState.PRUNED:
                        f.state = FlowState.ACTIVE
                        if isinstance(self.policy, MFSScheduler):
                            self.policy.readmit(f, self.view)

    def _apply_prune(self, bs: BatchState, item: PrefillItem) -> None:
        """Soft enforcement (Appendix B Step 3): demote the request's
        KV-reuse and P2D flows to the scavenger class. Scavenged Stage-1
        flows no longer block the batch; whatever has not arrived by the time
        its layer group runs is recomputed (paid in _recompute_penalty)."""
        for f in list(self.net.flows.values()):
            if f.rid != item.rid or f.stage == Stage.COLLECTIVE:
                continue
            f.state = FlowState.PRUNED
            if isinstance(self.policy, MFSScheduler):
                self.policy.prune(f)
        if bs.phase == "wait_s1":
            self._try_start_group(bs)

    # ------------------------------------------------------------------ run
    def run(self, max_events: int = 5_000_000) -> None:
        """Drain the event queue (arrivals must already be pushed)."""
        n_ev = 0
        while self.evq and n_ev < max_events:
            popped = self.evq.pop()
            if popped is None:
                break
            t, kind, payload, epoch = popped
            n_ev += 1
            if self._probe is not None:
                # BEFORE advance: current rates are exactly the rates active
                # over [net.now, t], so span/link integration here is exact
                self._probe.on_advance(self.net, t)
            done = self.net.advance(t)
            for f in done:
                self._on_flow_done(f)
            if kind == "arr":
                self._on_arrival(payload)
                self._resched(("submit",))
            elif kind == "compute":
                self._on_compute_done(*payload)
            elif kind == "tick":
                self._on_tick()
            elif kind == "dstep":
                if self.decode is not None \
                        and self.decode.on_step(payload, t):
                    self._resched(("submit",))   # rebalancer emitted D2D
                    self._arm_tick()
            elif kind == "net":
                if done:
                    self._resched(("event",))
                elif epoch == self._epoch:
                    # numerically-stalled prediction; force refresh
                    self._resched(("event",))
