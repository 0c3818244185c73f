"""Stage-emission layer of the shared MsFlow runtime (§3.1 + §5).

One implementation of the per-layer-group flow construction that both the
cluster simulator (``repro.simcluster``) and the real-JAX serving path
(``repro.serving``) drive through :class:`repro.core.runtime.MsFlowRuntime`:

  * Stage 1 — per-layer-group KV-reuse fetch flows from the prefix owner
    unit; the group-g slice must arrive before super-layer g computes.
  * Stage 2 — collective coflows per super-layer group: NIC-aggregated
    all-to-all for EP, ring KV exchange striped over TP endpoints for SP,
    scale-up all-reduce for TP. A coflow gates the next group's compute.
  * Stage 3 — P2D transfer of the group's produced KV toward the decode
    unit, carrying the explicit flow-level deadline derived from the
    request's TTFT deadline minus the remaining downstream work (§3.2).

The module is control-plane only (no JAX) and host-agnostic: all model math
comes from :class:`StageProfile`, an analytic latency/volume model over an
``ArchConfig`` + hardware profile, shared verbatim by simulation and
serving so both paths emit byte-identical stage sequences for matched
configurations (the pluggability claim of §5).

With a :class:`ChunkSpec` attached (Sarathi-style chunked prefill) every
stage is emitted per ``(group, chunk)`` instead of per group: Stage-1
fetches split at the chunk token budget, each chunk's collective gates the
next chunk, and chunk-*c* P2D overlaps chunk-*c+1* compute.
``chunk_tokens=0`` reproduces the group-granular emission bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .msflow import Coflow, Flow, Stage, new_flow_id

__all__ = [
    "ParallelismSpec",
    "GroupPlan",
    "ChunkSpec",
    "ChunkPlan",
    "StageProfile",
    "PrefillItem",
    "BatchState",
    "StageEmitter",
]


@dataclass(frozen=True)
class ParallelismSpec:
    """Parallelism of one prefill unit (one model replica).

    ``gpus`` is the number of NIC-attached endpoints the unit spans; the
    three modes reproduce the paper's Stage-2 traffic shapes (§6.1/§7).
    """

    mode: str = "ep"        # ep | sp | tp
    tp: int = 1
    ep: int = 1
    sp: int = 1

    @property
    def gpus(self) -> int:
        return self.tp * max(self.ep, 1) * max(self.sp, 1)


@dataclass(frozen=True)
class GroupPlan:
    """Partition of a model's L layers into G contiguous super-layers."""

    n_layers: int
    groups: Tuple[Tuple[int, ...], ...]

    @classmethod
    def build(cls, n_layers: int, n_groups: int) -> "GroupPlan":
        G = max(1, min(n_groups, n_layers))
        bounds = np.linspace(0, n_layers, G + 1).astype(int)
        return cls(n_layers=n_layers,
                   groups=tuple(tuple(range(bounds[g], bounds[g + 1]))
                                for g in range(G)))

    def __len__(self) -> int:
        return len(self.groups)

    def layers(self, g: int) -> Tuple[int, ...]:
        return self.groups[g]


@dataclass(frozen=True)
class ChunkSpec:
    """Sarathi-style chunked prefill configuration (``ClusterSpec.chunk`` /
    ``DisaggConfig.chunk``).

    ``chunk_tokens`` is the per-batch token budget of one compute chunk:
    each super-layer group's computation is split into sub-group chunks of
    at most that many *new* (non-reused) tokens, and Stage-1/2/3 emission
    happens per chunk — the chunk-*c* P2D overlaps chunk-*c+1* compute and
    the RLI/downstream estimate tightens to remaining-chunk compute.
    ``chunk_tokens=0`` (or a ``None`` spec) reproduces the legacy
    group-granular schedule bit-for-bit.
    """

    chunk_tokens: int = 2048


@dataclass(frozen=True)
class ChunkPlan:
    """Token-budgeted sub-group chunks of one prefill batch.

    The batch's *new* tokens (``max(1, n_tokens - reuse)`` per item, in item
    order) are cut every ``chunk_tokens`` tokens; a chunk may therefore span
    an item boundary and an item may span several chunks. The chunk axis is
    shared by every super-layer group — the runtime walks the
    ``(group, chunk)`` grid group-major, so chunk *c* of group *g* computes
    after chunk *c*'s collective of group *g-1* and after chunk *c-1* of
    group *g*.

    Per chunk the plan records, for every item, how many new tokens it
    contributes (``new_tokens``) and how many of its new tokens were already
    computed by earlier chunks (``prior_new`` — the attention-context
    offset). ``first_chunk``/``last_chunk`` give each item's chunk extent:
    the reused prefix KV ships with the first chunk's P2D (it is available
    as soon as the group's Stage-1 delivered) and the O(1) recurrent state
    with the last (it is final only at end of group).
    """

    chunk_tokens: int
    new_tokens: Tuple[Tuple[int, ...], ...]    # [chunk][item] -> new tokens
    prior_new: Tuple[Tuple[int, ...], ...]     # [chunk][item] -> done before
    first_chunk: Tuple[int, ...]               # [item] -> first chunk index
    last_chunk: Tuple[int, ...]                # [item] -> last chunk index

    @property
    def n_chunks(self) -> int:
        return len(self.new_tokens)

    @classmethod
    def build(cls, items: Sequence["PrefillItem"],
              chunk_tokens: int) -> Optional["ChunkPlan"]:
        if chunk_tokens <= 0:
            return None
        new = [max(1, it.n_tokens - it.reuse) for it in items]
        chunks: List[List[int]] = []
        priors: List[List[int]] = []
        done = [0] * len(items)
        left = list(new)
        while any(left):
            budget = chunk_tokens
            row = [0] * len(items)
            prior = list(done)
            for i, rem in enumerate(left):
                if budget <= 0:
                    break
                take = min(rem, budget)
                row[i] = take
                left[i] -= take
                done[i] += take
                budget -= take
            chunks.append(row)
            priors.append(prior)
        first = tuple(next(c for c, row in enumerate(chunks) if row[i] > 0)
                      for i in range(len(items)))
        last = tuple(max(c for c, row in enumerate(chunks) if row[i] > 0)
                     for i in range(len(items)))
        return cls(chunk_tokens=chunk_tokens,
                   new_tokens=tuple(tuple(r) for r in chunks),
                   prior_new=tuple(tuple(p) for p in priors),
                   first_chunk=first, last_chunk=last)

    def ship_tokens(self, item_idx: int, item: "PrefillItem",
                    c: int) -> int:
        """Prompt tokens whose KV ships with chunk ``c``'s P2D for one item:
        the chunk's new tokens, plus the reused prefix on the item's first
        chunk (totals telescope to ``item.n_tokens`` across chunks)."""
        t = self.new_tokens[c][item_idx]
        if t > 0 and c == self.first_chunk[item_idx]:
            t += item.n_tokens - max(1, item.n_tokens - item.reuse)
        return t


@dataclass
class PrefillItem:
    """One request as seen by the runtime: token counts + reuse + deadline.

    Hosts attach their own request object via ``payload`` (the simulator's
    trace ``Request``, the server's ``ServeRequest`` + prefix-index entry).
    """

    rid: int
    arrival: float
    n_tokens: int                      # prompt length
    reuse: int = 0                     # reused prefix tokens (Stage 1)
    owner_unit: int = 0                # unit owning the reused prefix
    # KV-reuse plane: per-tier/per-owner block plan resolved at route time
    # against live store state (repro.core.kvstore.HitPlan). When set it
    # supersedes the single-owner (reuse, owner_unit) pair and Stage-1
    # emission becomes multi-source.
    hit_plan: Any = None
    slo_scale: float = 0.0             # per-request SLO class scale (0 = use
    #                                    the pool default, then cluster-wide)
    slo_class: str = "standard"        # SLO class label (admission control
    #                                    sheds/defers only the sheddable ones)
    pool: str = ""                     # decode pool ("" = host/plane picks)
    out_tokens: int = 0                # output length (0 = decode plane samples)
    payload: Any = None
    # --- filled by the runtime ---
    unit: int = -1
    deferrals: int = 0                 # admission-control defer retries so far
    deadline: float = 0.0
    ideal_ttft: float = 0.0
    stalls: float = 0.0
    prefill_done: Optional[float] = None
    ttft: Optional[float] = None


@dataclass
class BatchState:
    """Lifecycle of one prefill batch on one unit."""

    bid: int
    unit: int
    items: List[PrefillItem]
    group_time: List[float]            # compute seconds per super-layer group
    started: float = 0.0
    cur_group: int = 0
    # chunked prefill: position on the (group, chunk) grid. With no plan the
    # chunk axis has length 1 and ``cur_chunk`` stays 0 (legacy schedule).
    cur_chunk: int = 0
    chunk_plan: Optional[ChunkPlan] = None
    chunk_time: List[List[float]] = field(default_factory=list)  # [group][chunk]
    phase: str = "wait_s1"             # wait_s1 | compute | wait_coll | drain
    stall_begin: Optional[float] = None
    s1_pending: Dict[int, Set[int]] = field(default_factory=dict)  # group -> fids
    coll: Optional[Coflow] = None
    coll_started: float = 0.0
    p2d_pending: Dict[int, Set[int]] = field(default_factory=dict)  # rid -> outstanding fids
    p2d_last: Dict[int, float] = field(default_factory=dict)        # rid -> latest P2D finish
    recompute_extra: float = 0.0       # legacy aggregate (kept for estimates)
    recomputed: Set[Tuple[int, int]] = field(default_factory=set)   # (rid, group)
    compute_done_at: Optional[float] = None

    @property
    def tokens(self) -> int:
        return sum(i.n_tokens for i in self.items)


class StageProfile:
    """Analytic model math shared by simulation and serving (§6.1).

    Derives compute latencies, per-group KV volumes, Stage-2 collective
    volumes and contention-free (ideal) TTFTs from an ``ArchConfig`` and a
    hardware profile. Instances are duck-typed over ``model`` (needs
    ``n_layers``/``kv_bytes_per_token_layer``/``flops_per_token``/
    ``params_active``/``state_bytes``/``is_moe_layer``/``top_k``/``d_model``)
    and ``hw`` (needs ``flops``/``mfu``/``nic_bw``) so repro.core stays free
    of upward imports.
    """

    def __init__(self, model: Any, hw: Any, par: ParallelismSpec,
                 plan: GroupPlan, kv_dtype_bytes: int = 2,
                 act_dtype_bytes: int = 2, gpus_per_server: int = 4):
        self.model = model
        self.hw = hw
        self.par = par
        self.plan = plan
        self.kv_dtype_bytes = kv_dtype_bytes
        self.act_dtype_bytes = act_dtype_bytes
        self.gpus_per_server = gpus_per_server

    # ------------------------------------------------------------ KV volumes
    def kv_bytes_group(self, g: int) -> float:
        """Per-token KV bytes produced by super-layer group ``g``."""
        m, b = self.model, self.kv_dtype_bytes
        return sum(m.kv_bytes_per_token_layer(b, l) for l in self.plan.layers(g))

    def state_bytes_group(self) -> float:
        """Per-request O(1) recurrent state shipped with each P2D group."""
        return self.model.state_bytes(self.kv_dtype_bytes) / len(self.plan)

    def kv_bytes_per_token(self) -> float:
        """Full-depth per-token KV bytes (D2D migrations move the whole
        context's KV, not one super-layer group's slice)."""
        return sum(self.kv_bytes_group(g) for g in range(len(self.plan)))

    # --------------------------------------------------------------- compute
    def group_compute_time(self, items: Sequence[PrefillItem], g: int) -> float:
        """Analytic compute latency of one super-layer group for a batch."""
        m, hw, par = self.model, self.hw, self.par
        L = m.n_layers
        flops = 0.0
        for it in items:
            new = max(1, it.n_tokens - it.reuse)
            ctx = it.reuse + new / 2.0
            flops += new * m.flops_per_token(ctx) / L * len(self.plan.layers(g))
        return flops / (par.gpus * hw.flops * hw.mfu)

    def chunk_compute_time(self, items: Sequence[PrefillItem],
                           plan: ChunkPlan, g: int, c: int) -> float:
        """Analytic compute latency of chunk ``c`` of super-layer group
        ``g``. Each item's chunk tokens attend over the reused prefix plus
        the new tokens earlier chunks already computed (midpoint context,
        as in :meth:`group_compute_time` — for context-linear FLOP models
        the per-chunk times sum to the group time up to rounding)."""
        m, hw, par = self.model, self.hw, self.par
        L = m.n_layers
        flops = 0.0
        for i, it in enumerate(items):
            n_c = plan.new_tokens[c][i]
            if n_c <= 0:
                continue
            ctx = it.reuse + plan.prior_new[c][i] + n_c / 2.0
            flops += n_c * m.flops_per_token(ctx) / L * len(self.plan.layers(g))
        return flops / (par.gpus * hw.flops * hw.mfu)

    def first_decode_time(self) -> float:
        m, hw, par = self.model, self.hw, self.par
        return 2.0 * m.params_active() / (par.gpus * hw.flops * hw.mfu * 0.3)

    def decode_step_time(self, n_seqs: int, mean_ctx: float) -> float:
        """One batched decode step on ONE decode endpoint: the larger of the
        compute time and the HBM time to stream the active weights plus the
        batch's KV (decode is memory-bound until the batch is deep)."""
        m, hw = self.model, self.hw
        flops_t = 2.0 * m.params_active() * max(n_seqs, 1) \
            / (hw.flops * hw.mfu)
        mem = m.params_active() * self.kv_dtype_bytes \
            + max(n_seqs, 1) * mean_ctx * self.kv_bytes_per_token()
        return max(flops_t, mem / (hw.hbm_bw * hw.hbm_eff))

    def decode_step_roofline(self, n_seqs: int, mean_ctx: float, *,
                             block_k: int = 256) -> float:
        """Kernel-calibrated counterpart of :meth:`decode_step_time`: the
        attention term comes from the *actual* decode kernel's tiling
        (``repro.kernels.decode_attention.decode_attention_cost`` — GQA
        cache layout, 128-lane head padding, ``block_k`` KV padding,
        compute-skipped tail blocks) instead of the smooth
        ``ctx x kv_bytes_per_token`` approximation, and the attention
        flops the analytic model drops are counted. The slow calibration
        test + the ``decode.roofline.*`` microbench row record the model
        error between the two."""
        from ..kernels.decode_attention import decode_attention_cost
        m, hw = self.model, self.hw
        n = max(n_seqs, 1)
        heads = getattr(m, "n_kv", 0) or getattr(m, "n_heads", 1)
        hd = getattr(m, "hd", 128)
        attn_layers = sum(1 for l in range(m.n_layers)
                          if getattr(m, "layer_kind", lambda _l: "attn")(l)
                          == "attn")
        fl, by = decode_attention_cost(n, heads, hd, int(max(mean_ctx, 1)),
                                       block_k=block_k,
                                       dtype_bytes=self.kv_dtype_bytes)
        flops_t = (2.0 * m.params_active() * n + attn_layers * fl) \
            / (hw.flops * hw.mfu)
        mem = m.params_active() * self.kv_dtype_bytes + attn_layers * by
        return max(flops_t, mem / (hw.hbm_bw * hw.hbm_eff))

    def recompute_time(self, reuse_tokens: int, frac: float, g: int) -> float:
        """Compute seconds to re-derive the fraction ``frac`` of a request's
        reused KV for group ``g`` that pruning left undelivered."""
        m, hw, par = self.model, self.hw, self.par
        nlayers = len(self.plan.layers(g))
        flops = frac * reuse_tokens * m.flops_per_token(reuse_tokens / 2) \
            / m.n_layers * nlayers
        return flops / (par.gpus * hw.flops * hw.mfu)

    # ------------------------------------------------------------ collectives
    def stage2_volume_per_ep(self, tokens: float, g: int) -> float:
        """Bytes leaving ONE endpoint for group g's collectives (network)."""
        m, par, d = self.model, self.par, self.act_dtype_bytes
        nlayers = len(self.plan.layers(g))
        if par.mode == "ep":
            moe_layers = sum(1 for l in self.plan.layers(g) if m.is_moe_layer(l))
            per_layer = 2.0 * (tokens / par.ep) * m.top_k * m.d_model * d
            return per_layer * moe_layers    # cross-fabric share applied by caller
        if par.mode == "sp":
            vol = 0.0
            for l in self.plan.layers(g):
                kvb = m.kv_bytes_per_token_layer(self.act_dtype_bytes, l)
                vol += (par.sp - 1) * (tokens / par.sp) * kvb
            return vol / par.tp              # striped across TP endpoints
        # tp: 2 all-reduce per layer, ring cost, scale-up only
        return 2.0 * 2.0 * (par.tp - 1) / par.tp * tokens * m.d_model * d * nlayers / par.tp

    # ----------------------------------------------------------- ideal TTFT
    def ideal_ttft(self, item: PrefillItem) -> float:
        """Low-load (contention-free) TTFT for SLO calibration (§6.1)."""
        par, hw = self.par, self.hw
        total = 0.0
        for g in range(len(self.plan)):
            total += self.group_compute_time([item], g)
            if par.mode == "ep":
                eps_per_server = min(self.gpus_per_server, par.gpus)
                cross = 1.0 - eps_per_server / max(par.gpus, 1)
                v = self.stage2_volume_per_ep(item.n_tokens - item.reuse, g) * cross
                total += v / hw.nic_bw
            elif par.mode == "sp":
                v = self.stage2_volume_per_ep(item.n_tokens, g)
                total += v / hw.nic_bw
        # stage-1 of group 0 cannot be hidden even without contention
        if item.reuse:
            total += item.reuse * self.kv_bytes_group(0) / hw.nic_bw
        # last group's P2D is never overlapped with compute
        total += item.n_tokens * self.kv_bytes_group(len(self.plan) - 1) / hw.nic_bw
        return total + self.first_decode_time()


class StageEmitter:
    """Builds the Stage-1/2/3 flow sets for a batch (§3.1).

    Pure flow construction: registers pending-set bookkeeping on the
    ``BatchState`` but never submits — the runtime owns submission, so the
    same emitter serves both the simulator and the real-JAX data plane.
    """

    def __init__(self, profile: StageProfile, unit_eps: Sequence[Sequence[int]],
                 decode_eps: Sequence[int], topo: Any,
                 pool_eps: Optional[Dict[str, Sequence[int]]] = None,
                 chunk_tokens: int = 0):
        self.profile = profile
        self.par = profile.par
        self.plan = profile.plan
        self.unit_eps = [list(e) for e in unit_eps]
        self.decode_eps = list(decode_eps)
        # named multi-decode pools: P2D targets the owning request's pool
        # slice; None keeps the single flat decode pool (identical emission)
        self.pool_eps = {k: list(v) for k, v in pool_eps.items()} \
            if pool_eps else None
        self.topo = topo
        # chunked prefill: Stage-1 fetches split at the chunk token budget
        # (finer promotion + per-chunk recompute on pruning), Stage-2/3
        # emitted per (group, chunk) via stage2_chunk/stage3_chunk. 0 keeps
        # the legacy group-granular emission bit-for-bit.
        self.chunk_tokens = chunk_tokens

    def _decode_eps_for(self, item: PrefillItem) -> List[int]:
        if self.pool_eps is not None:
            eps = self.pool_eps.get(item.pool)
            if eps:
                return eps
        return self.decode_eps

    # ----------------------------------------------------------- placement
    def rank_endpoint(self, bs: BatchState, item: PrefillItem, g: int) -> int:
        """Endpoint that owns ``item``'s activations for group g."""
        eps = self.unit_eps[bs.unit]
        if self.par.mode == "ep":
            idx = bs.items.index(item) % len(eps)
            return eps[idx]
        # sp / tp: stripe across endpoints by group for multi-NIC egress
        return eps[g % len(eps)]

    # -------------------------------------------------------------- stage 1
    def _s1_flows(self, bs: BatchState, item: PrefillItem, g: int,
                  tokens: int, src_eps: Sequence[int],
                  tier_cap: Optional[float], out: List[Flow]) -> None:
        """Emit group ``g``'s fetch flow(s) for ``tokens`` reused tokens
        sourced from ``src_eps`` (sp mode stripes the slice across the
        destination unit's endpoints, as for single-source fetches).

        With chunked prefill the fetch is cut at the chunk token budget:
        every chunk-of-reuse becomes its own flow, so the scheduler promotes
        pieces independently and pruning recomputes only the chunks that
        never arrived. All pieces still gate chunk 0 of group ``g`` —
        causal attention needs the whole prefix before the group's first
        new token computes."""
        G = len(self.plan)
        if tokens <= 0:
            return
        if self.chunk_tokens > 0:
            pieces = [self.chunk_tokens] * (tokens // self.chunk_tokens)
            if tokens % self.chunk_tokens:
                pieces.append(tokens % self.chunk_tokens)
        else:
            pieces = [tokens]
        for piece in pieces:
            size = piece * self.profile.kv_bytes_group(g)
            if size <= 0:
                return
            if self.par.mode == "sp":
                ueps = self.unit_eps[bs.unit]
                dsts = [ueps[(g + i) % len(ueps)] for i in range(self.par.sp)]
                sizes = [size / self.par.sp] * self.par.sp
            else:
                dsts = [self.rank_endpoint(bs, item, g)]
                sizes = [size]
            for dst, sz in zip(dsts, sizes):
                f = Flow(new_flow_id(), item.rid, bs.unit, Stage.KV_REUSE,
                         sz, src=src_eps[g % len(src_eps)], dst=dst,
                         target_layer=g, n_layers=G)
                f.tier_cap = tier_cap
                bs.s1_pending.setdefault(g, set()).add(f.fid)
                out.append(f)

    def stage1(self, bs: BatchState) -> List[Flow]:
        """Per-layer-group KV-reuse fetch flows.

        With a KV-store hit plan attached the fetch is **multi-source**:
        each plan segment (a run of blocks resident on one tier/owner)
        contributes its own per-group flows from that segment's source
        endpoints, rate-limited at the tier's fetch bandwidth. Without a
        plan, the legacy single-owner path fetches everything from
        ``item.owner_unit``.
        """
        G = len(self.plan)
        out: List[Flow] = []
        for item in bs.items:
            plan = item.hit_plan
            if plan is not None and getattr(plan, "segments", None):
                for seg in plan.segments:
                    if seg.tokens <= 0:
                        continue
                    for g in range(G):
                        self._s1_flows(bs, item, g, seg.tokens, seg.src_eps,
                                       seg.tier_cap, out)
                continue
            if item.reuse <= 0:
                continue
            src_eps = self.unit_eps[item.owner_unit]
            for g in range(G):
                self._s1_flows(bs, item, g, item.reuse, src_eps, None, out)
        return out

    # -------------------------------------------------------------- stage 2
    def stage2(self, bs: BatchState) -> Optional[Coflow]:
        """Collective coflow of the current group (gates the next group)."""
        tokens_new = sum(max(1, it.n_tokens - it.reuse) for it in bs.items)
        tokens_seq = sum(it.n_tokens for it in bs.items)
        return self._stage2(bs, bs.cur_group, tokens_new, tokens_seq)

    def stage2_chunk(self, bs: BatchState, g: int, c: int) -> Optional[Coflow]:
        """Collective coflow of chunk ``c`` of group ``g`` (gates chunk
        ``c+1``'s compute — each chunk's forward pass runs its own
        all-to-all / ring exchange over the chunk's tokens). Chunk volumes
        telescope to the legacy group totals: new tokens go to their chunk,
        the reused prefix share rides the owning item's first chunk."""
        plan = bs.chunk_plan
        tokens_new = sum(plan.new_tokens[c])
        tokens_seq = sum(plan.ship_tokens(i, it, c)
                         for i, it in enumerate(bs.items))
        return self._stage2(bs, g, tokens_new, tokens_seq)

    def _stage2(self, bs: BatchState, g: int, tokens: int,
                tokens_seq: int) -> Optional[Coflow]:
        par, profile = self.par, self.profile
        G = len(self.plan)
        eps = self.unit_eps[bs.unit]
        co = Coflow(cid=new_flow_id(), rid=bs.items[0].rid, unit=bs.unit,
                    stage=Stage.COLLECTIVE, layer=g)
        if par.mode == "ep":
            vol_per_ep = profile.stage2_volume_per_ep(tokens, g)
            if vol_per_ep <= 0:
                return None
            servers: Dict[int, List[int]] = {}
            for e in eps:
                servers.setdefault(self.topo.server_of(e), []).append(e)
            for e in eps:
                my_srv = self.topo.server_of(e)
                for srv, members in servers.items():
                    if srv == my_srv:
                        continue
                    dst = members[eps.index(e) % len(members)]
                    sz = vol_per_ep * len(members) / len(eps)
                    fl = Flow(new_flow_id(), co.rid, bs.unit, Stage.COLLECTIVE,
                              sz, src=e, dst=dst, target_layer=g, n_layers=G)
                    fl.coflow = co.cid
                    co.flows.append(fl)
        elif par.mode == "sp":
            vol = profile.stage2_volume_per_ep(tokens_seq, g)
            if vol <= 0:
                return None
            sp, tp = par.sp, par.tp
            for rank in range(sp):
                nxt_rank = (rank + 1) % sp
                for t in range(tp):
                    src = eps[rank * tp + t]
                    dst = eps[nxt_rank * tp + t]
                    fl = Flow(new_flow_id(), co.rid, bs.unit, Stage.COLLECTIVE,
                              vol, src=src, dst=dst, target_layer=g, n_layers=G)
                    fl.coflow = co.cid
                    co.flows.append(fl)
        else:   # tp: scale-up all-reduce flows between neighbouring endpoints
            vol = profile.stage2_volume_per_ep(tokens, g)
            if vol <= 0:
                return None
            for i, e in enumerate(eps):
                dst = eps[(i + 1) % len(eps)]
                if dst == e:
                    continue
                fl = Flow(new_flow_id(), co.rid, bs.unit, Stage.COLLECTIVE,
                          vol, src=e, dst=dst, target_layer=g, n_layers=G)
                fl.coflow = co.cid
                co.flows.append(fl)
        if not co.flows:
            return None
        return co

    # -------------------------------------------------------------- stage 3
    def stage3(self, bs: BatchState, g: int, t_first_decode: float) -> List[Flow]:
        """P2D flows for group g with the derived flow-level deadline."""
        G = len(self.plan)
        kvb = self.profile.kv_bytes_group(g)
        state_b = self.profile.state_bytes_group()
        out: List[Flow] = []
        for item in bs.items:
            size = item.n_tokens * kvb + state_b
            if size <= 0:
                continue
            deps = self._decode_eps_for(item)
            dst = deps[(item.rid + g) % len(deps)] \
                if deps else self.rank_endpoint(bs, item, g)
            # Flow-level deadline = TTFT deadline minus remaining downstream
            # work (the first decode step) — the paper's "global TTFT
            # materialises into an explicit flow-level bound" (§3.2).
            f = Flow(new_flow_id(), item.rid, bs.unit, Stage.P2D, size,
                     src=self.rank_endpoint(bs, item, g), dst=dst,
                     target_layer=g, n_layers=G,
                     deadline=item.deadline - t_first_decode)
            bs.p2d_pending[item.rid].add(f.fid)
            out.append(f)
        return out

    def stage3_chunk(self, bs: BatchState, g: int, c: int,
                     t_first_decode: float) -> List[Flow]:
        """P2D flows for chunk ``c`` of group ``g`` — the chunk's share of
        the group's produced KV leaves while later chunks still compute.

        Per item the chunk ships its new tokens' KV, plus the reused
        prefix's group-``g`` KV with the item's first chunk (available once
        the group's Stage-1 delivered) and the O(1) recurrent state with
        its last chunk (final only at end of group), so per-request totals
        and deadlines match :meth:`stage3` exactly. All of one item's
        chunks target the same decode endpoint — a request's group KV must
        land on one unit."""
        plan = bs.chunk_plan
        G = len(self.plan)
        kvb = self.profile.kv_bytes_group(g)
        state_b = self.profile.state_bytes_group()
        out: List[Flow] = []
        for i, item in enumerate(bs.items):
            size = plan.ship_tokens(i, item, c) * kvb
            if c == plan.last_chunk[i]:
                size += state_b
            if size <= 0:
                continue
            deps = self._decode_eps_for(item)
            dst = deps[(item.rid + g) % len(deps)] \
                if deps else self.rank_endpoint(bs, item, g)
            f = Flow(new_flow_id(), item.rid, bs.unit, Stage.P2D, size,
                     src=self.rank_endpoint(bs, item, g), dst=dst,
                     target_layer=g, n_layers=G,
                     deadline=item.deadline - t_first_decode)
            bs.p2d_pending[item.rid].add(f.fid)
            out.append(f)
        return out
