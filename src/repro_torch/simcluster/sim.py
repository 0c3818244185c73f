"""ClusterSim — event-driven disaggregated-serving simulator (Vidur+flowsim).

Thin host over the shared MsFlow runtime (``repro.core.runtime``): the
event loop, stage emission (per-layer-group Stage-1 KV-reuse flows, Stage-2
ep/sp/tp coflows, Stage-3 P2D with deadline derivation), SLO calibration
and the SchedView handed to policies all live in the runtime and are shared
verbatim with the real-JAX serving path (``repro.serving.disagg``). This
module contributes only what is simulation-specific:

  * cluster sizing — units, parallelism spec, ToR / fat-tree topology,
    decode-endpoint pool (optionally partitioned into named multi-decode
    pools driven by a ``DecodeSpec`` — the decode plane with per-token
    progress, TPOT metrics and D2D rebalancing flows);
  * KV-affinity routing over synthetic prefix ids (Zipf traces), which
    also pins each request to its decode pool;
  * metrics collection into :class:`SimMetrics`.

A *prefill unit* hosts one model replica on ``gpus_per_unit`` endpoints with
one of three parallelism modes (``ep`` — request-level DP attention + MoE
all-to-all; ``sp`` — sequence-sharded ring KV exchange; ``tp`` — scale-up
collectives only, §7), exactly as described in the stage-emission layer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from typing import Optional

from ..configs.base import ArchConfig
from ..core import Coflow, Policy
from ..core.decode import (DecodePlane, DecodeSession, DecodeSpec,
                           partition_pools)
from ..core.kvstore import KVStore, KVStoreSpec, chain_keys
from ..core.router import AdmissionSpec, RouterSpec
from ..core.runtime import MsFlowRuntime, RuntimeHost
from ..core.stages import (BatchState, ChunkSpec, GroupPlan, ParallelismSpec,
                           PrefillItem, StageEmitter, StageProfile)
from ..core.monitor import Monitor, MonitorSpec
from ..core.telemetry import Telemetry, TelemetrySpec
from ..netsim import EventQueue, FatTree, FluidNet, SingleToR, Topology
from .hw import HW, A100
from .metrics import CoflowRecord, SimMetrics
from .trace import Request

__all__ = ["ParallelismSpec", "ClusterSpec", "ClusterSim", "ChunkSpec",
           "DecodeSpec", "KVStoreSpec", "RouterSpec", "AdmissionSpec",
           "TelemetrySpec", "MonitorSpec"]


@dataclass
class ClusterSpec:
    model: ArchConfig
    par: ParallelismSpec
    hw: HW = A100
    n_units: int = 2
    gpus_per_server: int = 4
    topology: str = "tor"              # tor | fattree
    decode_ratio: float = 1.0          # decode endpoints per prefill endpoint
    max_batch_tokens: int = 8192
    slo_scale: float = 3.0
    slo_mode: str = "fixed"            # fixed: slo_scale x mean low-load TTFT
    #                                    per-request: slo_scale x own ideal
    kv_dtype_bytes: int = 2
    act_dtype_bytes: int = 2
    layer_groups: int = 0              # 0 = auto (clamp L into [8, 16])
    tick_interval: float = 2e-3
    drop_budget: int = 32              # Algorithm 1 global drop budget B
    hosts_per_rack: int = 8
    # decode plane (None = legacy behavior: requests end at the first token
    # and the sim is bit-identical to pre-decode-plane runs)
    decode: Optional[DecodeSpec] = None
    # KV-reuse plane (None = legacy behavior: the trace's pre-sampled
    # reuse_len + static prefix_id%n_units owner, bit-identical to
    # pre-kvstore runs). With a spec attached, hits resolve at route time
    # against the live tiered store, S1 becomes multi-source, and prefill
    # completion emits Stage-WB writeback flows.
    kvstore: Optional[KVStoreSpec] = None
    # chunked prefill (None = legacy group-granular schedule, bit-identical
    # to pre-chunking runs). With a spec attached every super-layer group's
    # compute is split into token-budgeted chunks and S1/S2/S3 are emitted
    # per chunk (chunk-c P2D overlaps chunk-c+1 compute; RLI tightens to
    # remaining-chunk compute). ``ChunkSpec(chunk_tokens=0)`` is also legacy.
    chunk: Optional[ChunkSpec] = None
    # router + admission plane (None = the default ``kv_affinity`` policy
    # with admission off, which reproduces the historical placement
    # bit-for-bit). A spec picks the placement policy from the router
    # registry and may attach overload-triggered admission control.
    router: Optional[RouterSpec] = None
    # telemetry plane (None = off, the legacy zero-overhead path — stage
    # traces, TTFTs and benchmark sections stay byte-identical). With a spec
    # attached the runtime records request-lifecycle spans, the RMLQ/
    # Algorithm-1 decision audit and per-link contention telemetry; read
    # them via ``ClusterSim.telemetry`` (ttft_breakdown / slo_miss_report /
    # link_report / to_chrome_trace).
    telemetry: Optional[TelemetrySpec] = None
    # online monitor plane (None = off, zero-overhead like telemetry). With
    # a spec attached the runtime streams event-clock estimators — rolling
    # link utilization/contended share, slack-loss rates, TTFT/TPOT
    # quantile sketches — onto a SignalBus that overload detectors and
    # router policies read live; see ``ClusterSim.monitor``.
    monitor: Optional[MonitorSpec] = None

    def chunk_tokens(self) -> int:
        return self.chunk.chunk_tokens if self.chunk is not None else 0

    def n_groups(self) -> int:
        if self.layer_groups:
            return self.layer_groups
        L = self.model.n_layers
        return max(1, min(L, 16 if L >= 16 else L))


class ClusterSim(RuntimeHost):
    def __init__(self, spec: ClusterSpec, policy: Policy, seed: int = 0,
                 contention_free: bool = False):
        self.spec = spec
        self.policy = policy
        policy.reset()
        self.rng = np.random.default_rng(seed)

        par = spec.par
        n_prefill = spec.n_units * par.gpus
        n_decode = int(math.ceil(n_prefill * spec.decode_ratio))
        n_store = spec.kvstore.n_store_nodes() if spec.kvstore else 0
        total = n_prefill + n_decode + n_store
        if spec.topology == "tor":
            self.topo: Topology = SingleToR(
                total, nic_bw=spec.hw.nic_bw,
                gpus_per_server=spec.gpus_per_server,
                scaleup_bw=spec.hw.scaleup_bw)
        else:
            racks = max(1, math.ceil(total / spec.hosts_per_rack))
            self.topo = FatTree(racks, spec.hosts_per_rack,
                                nic_bw=spec.hw.nic_bw,
                                gpus_per_server=spec.gpus_per_server,
                                scaleup_bw=spec.hw.scaleup_bw)

        plan = GroupPlan.build(spec.model.n_layers, spec.n_groups())
        self.profile = StageProfile(
            model=spec.model, hw=spec.hw, par=par, plan=plan,
            kv_dtype_bytes=spec.kv_dtype_bytes,
            act_dtype_bytes=spec.act_dtype_bytes,
            gpus_per_server=spec.gpus_per_server)
        unit_eps = [list(range(u * par.gpus, (u + 1) * par.gpus))
                    for u in range(spec.n_units)]
        decode_eps = list(range(n_prefill, n_prefill + n_decode))
        store_eps = list(range(n_prefill + n_decode, total))
        self.kvstore: Optional[KVStore] = None
        if spec.kvstore is not None:
            pooled = spec.kvstore.pooled_tier()
            if pooled is not None and pooled.fetch_bw > 0:
                # the pooled tier's nodes expose its fetch bandwidth as
                # their NIC capacity (store egress/ingress bound)
                for e in store_eps:
                    self.topo.capacity[2 * e] = pooled.fetch_bw
                    self.topo.capacity[2 * e + 1] = pooled.fetch_bw
            self.kvstore = KVStore(
                spec.kvstore, self.profile.kv_bytes_per_token(),
                unit_eps, store_eps, nic_bw=spec.hw.nic_bw)
        self.decode_plane: Optional[DecodePlane] = None
        pool_eps = None
        if spec.decode is not None:
            pool_eps = partition_pools(spec.decode.pools, decode_eps)
            self.decode_plane = DecodePlane(spec.decode, self.profile,
                                            pool_eps, seed=seed)
        emitter = StageEmitter(self.profile, unit_eps, decode_eps, self.topo,
                               pool_eps=pool_eps,
                               chunk_tokens=spec.chunk_tokens())
        rspec = spec.router
        self.telemetry: Optional[Telemetry] = \
            Telemetry(spec.telemetry) if spec.telemetry is not None \
            and spec.telemetry.enabled else None
        self.monitor: Optional[Monitor] = \
            Monitor(spec.monitor) if spec.monitor is not None \
            and spec.monitor.enabled else None
        self.runtime = MsFlowRuntime(
            self.topo, FluidNet(self.topo), EventQueue(), policy,
            self.profile, emitter, host=self, n_units=spec.n_units,
            max_batch_tokens=spec.max_batch_tokens, slo_scale=spec.slo_scale,
            slo_mode=spec.slo_mode, tick_interval=spec.tick_interval,
            drop_budget=spec.drop_budget, contention_free=contention_free,
            decode=self.decode_plane, kvstore=self.kvstore,
            router=rspec.build() if rspec is not None else None,
            admission=rspec.build_admission() if rspec is not None else None,
            telemetry=self.telemetry, monitor=self.monitor)
        self.metrics = SimMetrics(policy=policy.name)

    # kept as properties so tooling (and tests) can poke at the shared state
    @property
    def net(self) -> FluidNet:
        return self.runtime.net

    @property
    def view(self):
        return self.runtime.view

    # ------------------------------------------------------------ host hooks
    # Placement lives in the runtime's router plane now: trace items arrive
    # with the legacy (reuse, owner_unit) oracle pre-filled, so the default
    # no-op ``prepare_route`` suffices — the ``kv_affinity`` policy reads
    # the oracle (store off) or live store residency (store on), and the
    # runtime resolves the winner's block plan. Pool selection still rides
    # on routing: the runtime fills ``item.pool`` via
    # ``DecodePlane.pick_pool`` right after placement.

    def kv_chain_keys(self, item: PrefillItem):
        # the keys the router plane scores and the runtime resolves, also
        # used by store-aware SLO calibration
        r: Request = item.payload
        return chain_keys(r.prefix_chain, self.kvstore.spec.block_tokens) \
            if self.kvstore is not None else ()

    def on_shed(self, item: PrefillItem) -> None:
        # shed requests never ran: no TTFT, but they count as SLO misses in
        # all-arrivals attainment (SimMetrics.slo_attainment)
        r: Request = item.payload
        self.metrics.shed[r.rid] = r.slo_class

    def on_admitted(self, item: PrefillItem) -> None:
        r: Request = item.payload
        r.unit = item.unit
        r.deadline = item.deadline
        r.ideal_ttft = item.ideal_ttft
        self.metrics.arrival[r.rid] = r.arrival
        self.metrics.prompt_tokens[r.rid] = item.n_tokens
        # metrics store the *relative* TTFT budget (deadline - arrival) so it
        # compares directly against the recorded (relative) TTFT
        self.metrics.deadline[r.rid] = item.deadline - item.arrival
        self.metrics.ideal_ttft[r.rid] = item.ideal_ttft
        self.metrics.slo_class[r.rid] = r.slo_class
        if item.hit_plan is not None and r.rid >= 0:
            self.metrics.kv_hit_tokens[r.rid] = item.hit_plan.tokens
            self.metrics.kv_prompt_tokens[r.rid] = item.n_tokens
            for tier, tok in item.hit_plan.tier_tokens().items():
                self.metrics.kv_tier_tokens[tier] = \
                    self.metrics.kv_tier_tokens.get(tier, 0) + tok

    def on_batch_started(self, bs: BatchState) -> None:
        for it in bs.items:
            it.payload.batch = bs.bid

    def on_request_done(self, item: PrefillItem, bs: BatchState) -> None:
        r: Request = item.payload
        r.prefill_done = item.prefill_done
        r.stalls = item.stalls
        r.ttft = item.ttft
        self.metrics.ttft[r.rid] = item.ttft
        self.metrics.stall_time[r.rid] = item.stalls

    def on_coflow_done(self, bs: BatchState, co: Coflow, ideal: float) -> None:
        self.metrics.coflows.append(CoflowRecord(
            co.cid, bs.unit, co.layer, co.started, self.runtime.net.now,
            co.size, ideal))

    def on_decode_admitted(self, sess: DecodeSession) -> None:
        self.metrics.pool_of[sess.rid] = sess.pool

    def on_decode_done(self, sess: DecodeSession) -> None:
        self.metrics.tpot[sess.rid] = sess.tpot
        self.metrics.tbt_max[sess.rid] = sess.gap_max
        self.metrics.tpot_budget[sess.rid] = sess.tpot_budget

    # ------------------------------------------------------------------ run
    def build_items(self, requests: Sequence[Request]) -> List[PrefillItem]:
        """Trace requests -> runtime items (the exact objects ``run()``
        pushes), with SLO calibration applied. Exposed so offline analyses
        — e.g. the max-flow yardstick's demand replay — see the same
        deadlines/reuse the live run would."""
        import copy
        items: List[PrefillItem] = []
        for r in requests:
            # Requests carry runtime state; copy so one trace can be replayed
            # across policies/seeds without cross-contamination.
            r = copy.copy(r)
            # legacy (store-off) reuse model: pre-sampled reuse_len + static
            # modulo owner; with the KV-reuse plane attached, route()
            # overrides both from the live store
            items.append(PrefillItem(
                rid=r.rid, arrival=r.arrival, n_tokens=r.prompt_len,
                reuse=r.reuse_len,
                owner_unit=r.prefix_id % self.spec.n_units,
                slo_scale=getattr(r, "slo_scale", 0.0),
                slo_class=getattr(r, "slo_class", "standard"),
                out_tokens=getattr(r, "out_len", 0), payload=r))
        self.runtime.calibrate_slo(items)
        return items

    def run(self, requests: Sequence[Request], max_events: int = 5_000_000) -> SimMetrics:
        items = self.build_items(requests)
        for it in items:
            self.runtime.push_arrival(it)
        self.runtime.run(max_events=max_events)
        self.metrics.pruned = self.runtime.n_pruned
        self.metrics.n_deferred = self.runtime.n_deferred
        self.metrics.stage_log_dropped = self.runtime.stage_log.dropped
        if self.decode_plane is not None:
            self.metrics.decode_stats = self.decode_plane.summary()
        if self.kvstore is not None:
            self.metrics.kvstore_stats = self.kvstore.summary()
        return self.metrics
