"""Disaggregated serving orchestrator — real PyTorch data plane, scheduled
transfers on a virtual network.

This is the paper's §5 integration re-based onto the shared MsFlow runtime
(``core/runtime.py``): the event loop, per-layer-group stage emission
(Stage-1 KV-reuse fetches, Stage-2 collectives, Stage-3 P2D with deadline
derivation), SLO calibration and the policy-facing SchedView are the same
objects the cluster simulator drives — MFS is exercised at full fidelity
(RMLQ promotion, Algorithm 1 RED ordering + feasibility pruning, scavenger
readmission) on the real-model path, with no degenerate stubs.

What this module contributes is the *data plane*:

  * prefill units run the actual model (``ServingEngine``) — results are
    exact; latency on the target cluster comes from the shared analytic
    ``StageProfile``, so the virtual clock reflects target-hardware timing;
  * KV-aware routing over a content-addressed ``PrefixIndex`` (real pages);
  * queued multi-request prefill batching per unit (token-capped, like the
    simulator) instead of one-request-at-a-time service;
  * decode via slotted continuous batching on the decode unit (real tokens).

Request lifecycle (one MsFlow chain per request, §3.1):
  arrival -> route to a prefill unit (prefix-affinity vs. backlog)
    Stage 1: prefix-index hit => per-layer-group KV-reuse flows from the
             owner unit; group g's slice gates super-layer g's compute
    compute: per super-layer group; at each boundary a "layer" trigger
             promotes (RMLQ), Stage-2 coflows gate the next group, and the
             group's P2D KV (Stage 3) carries the derived TTFT deadline
    TTFT   = completion of the last P2D flow + first decode step
  decode  -> slotted continuous batching on the decode unit (real tokens).
             With ``DisaggConfig.decode`` set, the modeled decode plane
             (named pools over ``n_decode_units`` endpoints, per-token
             ``dstep`` events, D2D rebalancing flows) also runs on the
             virtual clock — the same ``DecodePlane`` the simulator
             drives, so decode event traces are host-parity-testable.

Pruned requests (Algorithm 1) keep their *results* exact: the prefix pages
are local, so the real prefill still reuses them — only the modeled clock
pays the recompute penalty for KV the scavenged Stage-1 flow never
delivered, exactly as the simulator charges it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import MFSScheduler, Policy
from ..core.decode import (DecodePlane, DecodeSession, DecodeSpec,
                           partition_pools)
from ..core.kvstore import KVStore, KVStoreSpec, content_chain
from ..core.router import AdmissionSpec, RouterSpec
from ..core.runtime import MsFlowRuntime, RuntimeHost
from ..core.stages import (BatchState, ChunkSpec, GroupPlan, ParallelismSpec,
                           PrefillItem, StageEmitter, StageProfile)
from ..core.monitor import Monitor, MonitorSpec
from ..core.telemetry import Telemetry, TelemetrySpec
from ..netsim.events import EventQueue
from ..netsim.fluid import FluidNet
from ..netsim.topology import SingleToR
from ..simcluster.hw import H100, HW
from .engine import DecodeBatch, ServingEngine
from .paged_kv import (PagedStore, PrefixIndex, cache_has_state,
                       tree_map_with_path)

__all__ = ["DisaggServer", "ServeRequest", "ServeResult", "DisaggConfig"]


@dataclass
class ServeRequest:
    rid: int
    arrival: float
    tokens: np.ndarray
    max_new: int = 8
    slo_class: str = "standard"     # tight | standard | loose (admission
    #                                 control sheds only the sheddable ones)
    extra: Optional[Dict[str, Any]] = None     # e.g. src_embeds for enc-dec


@dataclass
class ServeResult:
    rid: int
    ttft: float
    deadline: float
    met_slo: bool
    first_token: int
    tokens: List[int] = field(default_factory=list)
    reused_tokens: int = 0
    unit: int = -1
    pruned: bool = False
    shed: bool = False              # rejected by admission control: never
    #                                 prefilled, no first token, SLO missed
    # --- decode plane (modeled clock; real tokens come from DecodeBatch) ---
    pool: str = ""
    tpot: float = 0.0               # mean modeled time per output token
    tpot_ok: bool = True
    migrations: int = 0


@dataclass(frozen=True)
class DisaggConfig:
    n_prefill_units: int = 2
    hw: HW = H100
    layer_groups: int = 4           # P2D / promotion granularity
    slo_scale: float = 3.0          # SLO = scale x contention-free TTFT (§6.1)
    page_size: int = 16
    n_pages: int = 1024
    decode_capacity: int = 256
    decode_slots: int = 8
    kv_dtype_bytes: int = 2
    gpus_per_unit: int = 1          # endpoints (= modeled EP ranks) per unit
    max_batch_tokens: int = 8192    # prefill batch cap per unit
    tick_interval: float = 2e-3     # post-compute MLU re-evaluation pitch
    drop_budget: int = 32           # Algorithm 1 global drop budget B
    n_decode_units: int = 1         # modeled decode endpoints (pools split these)
    decode: Optional[DecodeSpec] = None   # attach the modeled decode plane
    # KV-reuse plane: with a spec attached, scheduling truth (reuse length,
    # sources, tiers) comes from the shared tiered KVStore — the
    # content-addressed PrefixIndex stays the *data-plane* page map that
    # materialises real prefix caches when it can cover the modeled hit.
    kvstore: Optional[KVStoreSpec] = None
    # chunked prefill: the modeled clock walks the (group, chunk) grid with
    # per-chunk S1/S2/S3 emission, and the data plane materialises paged
    # prefix caches in chunk slices (PagedStore.gather_slice) instead of
    # one monolithic gather. None (or chunk_tokens=0) = legacy schedule.
    chunk: Optional[ChunkSpec] = None
    # router + admission plane (None = the default ``kv_affinity`` policy
    # with admission off — the historical placement, bit-identical).
    router: Optional[RouterSpec] = None
    # telemetry plane (None = off, zero overhead); read the collector via
    # ``DisaggServer.telemetry`` after a run for ttft_breakdown /
    # slo_miss_report / the RMLQ audit / Chrome trace export
    telemetry: Optional[TelemetrySpec] = None
    # online monitor plane (None = off): streaming estimators + SignalBus
    # for live detectors/routers; read via ``DisaggServer.monitor``
    monitor: Optional[MonitorSpec] = None

    def chunk_tokens(self) -> int:
        return self.chunk.chunk_tokens if self.chunk is not None else 0


@dataclass
class _ServeJob:
    """Data-plane state riding on a PrefillItem as its payload."""

    req: ServeRequest
    entry: Any = None               # PrefixIndex hit backing the reuse
    cache: Any = None
    first_token: int = -1


class DisaggServer(RuntimeHost):
    """One decode unit + N prefill units sharing a ToR, MFS-scheduled."""

    def __init__(self, model: Any, policy: Policy = None,
                 cfg: DisaggConfig = DisaggConfig()):
        self.model = model
        self.cfg = cfg
        self.policy = policy if policy is not None else MFSScheduler()
        self.policy.reset()

        n_prefill = cfg.n_prefill_units * cfg.gpus_per_unit
        n_decode = max(1, cfg.n_decode_units)
        n_store = cfg.kvstore.n_store_nodes() if cfg.kvstore else 0
        self.topo = SingleToR(n_prefill + n_decode + n_store,
                              nic_bw=cfg.hw.nic_bw,
                              gpus_per_server=cfg.gpus_per_unit,
                              scaleup_bw=cfg.hw.scaleup_bw)
        mcfg = model.cfg
        par = ParallelismSpec(mode="ep", ep=cfg.gpus_per_unit)
        plan = GroupPlan.build(mcfg.n_layers,
                               min(cfg.layer_groups, mcfg.n_layers))
        self.profile = StageProfile(
            model=mcfg, hw=cfg.hw, par=par, plan=plan,
            kv_dtype_bytes=cfg.kv_dtype_bytes, act_dtype_bytes=2,
            gpus_per_server=cfg.gpus_per_unit)
        unit_eps = [list(range(u * cfg.gpus_per_unit,
                               (u + 1) * cfg.gpus_per_unit))
                    for u in range(cfg.n_prefill_units)]
        decode_eps = list(range(n_prefill, n_prefill + n_decode))
        store_eps = list(range(n_prefill + n_decode,
                               n_prefill + n_decode + n_store))
        self.kvstore: Optional[KVStore] = None
        if cfg.kvstore is not None:
            if cfg.kvstore.block_tokens % cfg.page_size:
                raise ValueError("kvstore.block_tokens must be a multiple of"
                                 " page_size so block-aligned hits are valid"
                                 " paged-cache resume points")
            pooled = cfg.kvstore.pooled_tier()
            if pooled is not None and pooled.fetch_bw > 0:
                for e in store_eps:
                    self.topo.capacity[2 * e] = pooled.fetch_bw
                    self.topo.capacity[2 * e + 1] = pooled.fetch_bw
            self.kvstore = KVStore(
                cfg.kvstore, self.profile.kv_bytes_per_token(),
                unit_eps, store_eps, nic_bw=cfg.hw.nic_bw)
        self.decode_plane: Optional[DecodePlane] = None
        pool_eps = None
        if cfg.decode is not None:
            pool_eps = partition_pools(cfg.decode.pools, decode_eps)
            self.decode_plane = DecodePlane(cfg.decode, self.profile,
                                            pool_eps, seed=0)
        emitter = StageEmitter(self.profile, unit_eps,
                               decode_eps=decode_eps, topo=self.topo,
                               pool_eps=pool_eps,
                               chunk_tokens=cfg.chunk_tokens())
        rspec = cfg.router
        self.telemetry: Optional[Telemetry] = \
            Telemetry(cfg.telemetry) if cfg.telemetry is not None \
            and cfg.telemetry.enabled else None
        self.monitor: Optional[Monitor] = \
            Monitor(cfg.monitor) if cfg.monitor is not None \
            and cfg.monitor.enabled else None
        self.runtime = MsFlowRuntime(
            self.topo, FluidNet(self.topo), EventQueue(), self.policy,
            self.profile, emitter, host=self, n_units=cfg.n_prefill_units,
            max_batch_tokens=cfg.max_batch_tokens, slo_scale=cfg.slo_scale,
            slo_mode="per-request", tick_interval=cfg.tick_interval,
            drop_budget=cfg.drop_budget, decode=self.decode_plane,
            kvstore=self.kvstore,
            router=rspec.build() if rspec is not None else None,
            admission=rspec.build_admission() if rspec is not None else None,
            telemetry=self.telemetry, monitor=self.monitor)

        self.engines = [ServingEngine(model)
                        for _ in range(cfg.n_prefill_units)]
        self.decoder = DecodeBatch(model, capacity=cfg.decode_capacity,
                                   max_slots=cfg.decode_slots)
        self.store = PagedStore(cfg.page_size, cfg.n_pages)
        self.index = PrefixIndex(self.store)
        self.results: Dict[int, ServeResult] = {}

    @property
    def net(self) -> FluidNet:
        return self.runtime.net

    # ----------------------------------------------------------- model math
    def _kv_bytes_per_token(self) -> float:
        m, b = self.model.cfg, self.cfg.kv_dtype_bytes
        return sum(m.kv_bytes_per_token_layer(b, l)
                   for l in range(m.n_layers))

    # ------------------------------------------------------------ host hooks
    def prepare_route(self, item: PrefillItem) -> None:
        """Refresh placement state before the runtime's router places.

        Matches the content-addressed PrefixIndex and fills the legacy
        ``(reuse, owner_unit)`` oracle the ``kv_affinity`` policy scores
        (``owner_unit = -1`` when no entry owns the prefix — the runtime
        self-assigns after placement). With the KV-reuse plane attached the
        oracle is ignored — the hit (length, sources, tiers) resolves
        against the live shared store after placement — and the PrefixIndex
        entry is kept only as the data-plane capability that materialises
        real pages for the modeled hit.
        """
        job: _ServeJob = item.payload
        entry = self.index.match(job.req.tokens)
        if self.kvstore is not None:
            job.entry = entry
            return
        reuse = entry.n_tokens if entry else 0
        if reuse >= len(job.req.tokens):    # guarantee >=1 suffix token
            reuse, entry = 0, None
        job.entry = entry
        item.reuse = reuse
        # decode pool: left empty here, so the runtime fills it via
        # DecodePlane.pick_pool after routing (set item.pool to override)
        item.owner_unit = entry.owner_unit if entry else -1

    def kv_chain_keys(self, item: PrefillItem):
        # the keys the router plane scores and the runtime resolves, also
        # used by store-aware SLO calibration
        if self.kvstore is None:
            return ()
        job: _ServeJob = item.payload
        return content_chain(job.req.tokens, self.kvstore.spec.block_tokens)

    def on_shed(self, item: PrefillItem) -> None:
        # rejected before any prefill ran: record a result so callers see
        # the outcome (no first token, SLO counted as missed)
        job: _ServeJob = item.payload
        r = job.req
        self.results[r.rid] = ServeResult(
            rid=r.rid, ttft=float("inf"), deadline=item.deadline,
            met_slo=False, first_token=-1, tokens=[], shed=True)

    def on_batch_started(self, bs: BatchState) -> None:
        # REAL compute (results are exact; the virtual clock runs on the
        # shared analytic profile). The prefix pages are host-local, so the
        # data plane can reuse them even when the modeled Stage-1 flow is
        # later pruned — only the clock pays the recompute penalty then.
        for it in bs.items:
            job: _ServeJob = it.payload
            prefix_cache = self._prefix_cache_for(job.entry, it.reuse)
            first, cache, _ = self.engines[bs.unit].prefill(
                job.req.tokens, prefix_cache=prefix_cache,
                prefix_len=it.reuse if prefix_cache is not None else 0,
                extra=job.req.extra)
            job.first_token = first
            job.cache = cache

    def _prefix_cache_for(self, entry: Any, reuse: int) -> Optional[Any]:
        """Materialise a prefix cache covering exactly ``reuse`` tokens.

        The modeled hit (KV store) and the data-plane capability
        (PrefixIndex) can disagree — the store evicts, the index does not —
        so paged entries are sliced down to the modeled hit and anything
        the index cannot cover is recomputed by the real prefill (results
        stay exact; the virtual clock already charged the modeled hit).

        With chunked prefill the paged prefix is materialised in
        ``chunk_tokens`` slices (``PagedStore.gather_slice``) and stitched
        along the token axis — the data-plane mirror of the per-chunk
        Stage-1 arrival granularity the modeled clock schedules.
        """
        if entry is None or reuse <= 0:
            return None
        ct = self.cfg.chunk_tokens()
        if entry.pages and ct > 0:
            bounds = list(range(0, reuse, ct)) + [reuse]
            slices = [self.store.gather_slice(entry.pages, a, b)
                      for a, b in zip(bounds, bounds[1:])]
            if len(slices) == 1:
                return slices[0]
            return tree_map_with_path(
                lambda _, *xs: torch.cat(xs, dim=2), *slices)
        if entry.n_tokens == reuse:
            return self.index.fetch(entry)
        if entry.pages and entry.n_tokens > reuse:
            return self.store.gather(entry.pages, reuse)
        return None                     # snapshot mismatch: recompute fully

    def on_request_done(self, item: PrefillItem, bs: BatchState) -> None:
        job: _ServeJob = item.payload
        r = job.req
        res = ServeResult(
            rid=r.rid, ttft=item.ttft, deadline=item.deadline,
            met_slo=(item.arrival + item.ttft) <= item.deadline,
            first_token=job.first_token, tokens=[job.first_token],
            reused_tokens=item.reuse, unit=item.unit,
            pruned=r.rid in self.runtime.ever_pruned)
        self.results[r.rid] = res
        # register the prefix for future reuse + hand off to the decode unit
        if cache_has_state(job.cache):
            self.index.insert_snapshot(r.tokens, job.cache, item.unit)
        else:
            try:
                pages = self.store.put(job.cache, len(r.tokens))
                self.index.insert_paged(r.tokens, pages, item.unit,
                                        self._kv_bytes_per_token())
                self.store.release(pages)   # index holds its own references
            except MemoryError:
                pass                         # pool full: skip registration
        if self.decoder.n_active < self.cfg.decode_slots:
            self.decoder.add(r.rid, job.cache, len(r.tokens),
                             job.first_token, max_new=r.max_new)
        job.cache = None

    def on_decode_admitted(self, sess: DecodeSession) -> None:
        res = self.results.get(sess.rid)
        if res is not None:
            res.pool = sess.pool

    def on_decode_done(self, sess: DecodeSession) -> None:
        res = self.results.get(sess.rid)
        if res is not None:
            res.tpot = sess.tpot
            res.tpot_ok = sess.tpot_ok
            res.migrations = sess.n_migrations

    # --------------------------------------------------------------- serving
    def serve(self, requests: Sequence[ServeRequest],
              decode_steps: int = 4) -> List[ServeResult]:
        for r in sorted(requests, key=lambda x: x.arrival):
            self.runtime.push_arrival(PrefillItem(
                rid=r.rid, arrival=r.arrival, n_tokens=len(r.tokens),
                slo_class=r.slo_class, out_tokens=r.max_new,
                payload=_ServeJob(req=r)))
        self.runtime.run()
        # all prefills finished: run the decode continuation (real tokens)
        for _ in range(decode_steps):
            if not self.decoder.n_active:
                break
            for rid, tok in self.decoder.step().items():
                self.results[rid].tokens.append(tok)
        return [self.results[r.rid] for r in requests]
