"""KV-reuse plane — a shared tiered prefix store with live hits (§3.1 S1).

Until this module existed the repo *faked* the paper's first stage: traces
pre-sampled a ``reuse_len`` and a static hash picked the owner unit, so a
cache hit never depended on what was actually resident anywhere and Stage-1
traffic never competed with the writebacks that create reusable KV in the
first place. This module is the real thing, following the production-stack
direction of KV-cache-aware routing over a shared LMCache-style store:

  * **Block-granular chain index.** A request's reusable prefix is a chain
    of fixed-size token blocks (``KVStoreSpec.block_tokens``). Chains are
    hierarchical — requests sharing an ancestor share the chain's leading
    blocks — so *partial-prefix* hits exist. Keys are opaque hashables:
    the simulator derives ``(node, j)`` pairs from trace prefix chains
    (:func:`chain_keys`), the serving path content-hashes real tokens
    (:func:`content_chain`); the store never needs to know which.
  * **Multi-tier placement.** Each :class:`TierSpec` is either ``unit``
    scoped (one location per prefill unit: endpoint HBM, host DRAM) or
    ``pooled`` (one shared remote store backed by dedicated fabric
    endpoints). Tiers carry a per-location byte capacity and a fetch
    bandwidth; fetches from a tier ride normal fluid-net flows whose
    ``tier_cap`` bounds their rate at the tier's read path.
  * **LRU + size-aware eviction.** Insertion over capacity evicts the
    least-recently-used *unpinned* blocks until the new block fits. Blocks
    are uniform-size (block granularity), so the size-aware tie-break
    degenerates to count — eviction cost is exact, not approximate.
    Blocks pinned by an in-flight Stage-1 fetch or writeback are never
    evicted from under the transfer.
  * **Live hit resolution at route time.** The router plane's default
    ``kv_affinity`` policy (``repro.core.router``) scores units by
    hit-weighted affinity vs. backlog (the same formula both hosts used
    for the static oracle) and then :meth:`KVStore.resolve` builds a
    per-tier, per-owner **block plan** against the store's state *now* —
    the ``StageEmitter`` turns each plan segment into per-layer-group
    Stage-1 flows from that segment's source endpoints, so S1 becomes
    multi-source (several owners/tiers at different bandwidths).
  * **Writeback flows (Stage ``WB``).** When a request's prefill completes
    the runtime admits its chain: blocks land in the producing unit's HBM
    tier immediately and replication flows toward every ``writeback`` tier
    enter the FluidNet with *loose derived deadlines*
    (``wb_deadline_scale`` x the tier-bandwidth transfer time). The MFS
    arbiter holds WB in an RMLQ band below D2D and bars it from the
    level-1 critical reservation; the stage-agnostic baselines see WB
    through their generic rules (EDF chases the explicit deadline, Karuna
    reserves minimal rate, FairShare splits evenly) and pay for it on the
    contended links — which is exactly the stage-diverse contention the
    paper's scheduler exists to arbitrate.

Control-plane only (numpy + hashlib, no JAX), host-agnostic like the rest
of ``repro.core``: ``ClusterSim`` and ``DisaggServer`` attach one store to
the shared runtime, whose router plane scores and resolves against it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np

from .msflow import Flow, Stage, new_flow_id

__all__ = ["TierSpec", "KVStoreSpec", "HitSegment", "HitPlan", "KVStore",
           "kv_route", "chain_keys", "content_chain"]


@dataclass(frozen=True)
class TierSpec:
    """One storage tier of the KV-reuse plane.

    ``scope="unit"`` places one location per prefill unit (endpoint HBM,
    host DRAM); ``scope="pooled"`` is one shared remote location backed by
    the store's dedicated fabric endpoints. ``capacity`` is bytes *per
    location*; ``fetch_bw`` (0 = uncapped) bounds each fetch/writeback
    flow's rate at the tier's read/write path via ``Flow.tier_cap``.
    ``writeback=True`` tiers receive Stage-``WB`` replication flows on
    prefill completion.
    """

    name: str
    capacity: float
    fetch_bw: float = 0.0
    scope: str = "unit"            # unit | pooled
    writeback: bool = False


#: default 3-tier layout; capacities are deliberately modest so sweeps see
#: capacity-bounded eviction (override per experiment)
_DEFAULT_TIERS = (
    TierSpec("hbm", capacity=4e9, fetch_bw=0.0, scope="unit"),
    TierSpec("dram", capacity=32e9, fetch_bw=30e9, scope="unit",
             writeback=True),
    TierSpec("remote", capacity=256e9, fetch_bw=24e9, scope="pooled",
             writeback=True),
)


@dataclass(frozen=True)
class KVStoreSpec:
    """KV-reuse plane configuration attached to a cluster/server spec."""

    block_tokens: int = 256        # hit/placement granularity (tokens)
    tiers: Tuple[TierSpec, ...] = _DEFAULT_TIERS
    pooled_nodes: int = 1          # fabric endpoints backing the pooled tier
    wb_deadline_scale: float = 8.0  # WB deadline = now + scale x ideal xfer
    # --- popularity-driven hot-block replication (0 = off) ---
    # A block resolved at least ``hot_threshold`` times is "hot": admission
    # and WB completion push copies of it toward additional units' DRAM
    # (the first unit-scoped writeback tier) until ``hot_copies`` units
    # hold one locally — production-stack-style prefetch that spreads the
    # Zipf victim-unit Stage-1 concentration before demand arrives.
    hot_threshold: int = 0
    hot_copies: int = 2
    # Exponential half-life (virtual-clock seconds) of the per-block resolve
    # popularity: a block's count halves every ``hot_halflife`` seconds of
    # not being resolved, so replication chases *current* popularity instead
    # of all-time totals (yesterday's hot prefixes cool off). 0 = no decay,
    # bit-identical to the pre-decay counters.
    hot_halflife: float = 0.0

    def __post_init__(self):
        if not self.tiers or self.tiers[0].scope != "unit":
            raise ValueError("tiers[0] must be the unit-scoped origin tier "
                             "(endpoint HBM) — prefill output lands there")
        if sum(1 for t in self.tiers if t.scope == "pooled") > 1:
            raise ValueError("at most one pooled tier is supported")

    def pooled_tier(self) -> Optional[TierSpec]:
        for t in self.tiers:
            if t.scope == "pooled":
                return t
        return None

    def n_store_nodes(self) -> int:
        return self.pooled_nodes if self.pooled_tier() is not None else 0


@dataclass(frozen=True)
class HitSegment:
    """A contiguous run of hit blocks sharing one (tier, owner) source."""

    tier: str
    tier_idx: int
    loc: int                       # owner unit (-1 = pooled)
    tokens: int
    src_eps: Tuple[int, ...]       # endpoints the fetch flows leave from
    tier_cap: Optional[float]      # per-flow fetch ceiling (None = uncapped)


@dataclass
class HitPlan:
    """Per-tier, per-owner block plan for one request's Stage-1 fetches."""

    tokens: int = 0
    segments: Tuple[HitSegment, ...] = ()

    def tier_tokens(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.segments:
            out[s.tier] = out.get(s.tier, 0) + s.tokens
        return out


# ---------------------------------------------------------------- chain keys
def chain_keys(prefix_chain: Sequence[Tuple[int, int]],
               block_tokens: int) -> Tuple[Hashable, ...]:
    """Flatten a trace prefix chain — ``((node_id, tokens), ...)`` — into
    block keys. Each node contributes its leading full blocks only, so two
    chains sharing ancestors share exactly the ancestors' block keys.
    Non-leaf node spans (``WorkloadSpec.chain_node_tokens``) should be a
    multiple of ``block_tokens`` so no ancestor tokens fall between
    blocks; only the leaf's trailing partial block is dropped."""
    out: List[Hashable] = []
    for node, tokens in prefix_chain:
        for j in range(int(tokens) // block_tokens):
            out.append((int(node), j))
    return tuple(out)


def content_chain(tokens: np.ndarray,
                  block_tokens: int) -> Tuple[Hashable, ...]:
    """Content-addressed block chain over real tokens (serving path).

    An incremental hash chain at block granularity — block ``i``'s key
    commits to every token before it, so identical leading blocks hash to
    identical keys across requests (hot prefixes dedupe). The chain covers
    at most ``len(tokens) - 1`` tokens: at least one suffix token must
    always be computed, never reused.
    """
    tokens = np.asarray(tokens)
    usable = max(0, len(tokens) - 1)
    out: List[Hashable] = []
    h = hashlib.sha256()
    for i in range(usable // block_tokens):
        h.update(np.ascontiguousarray(
            tokens[i * block_tokens:(i + 1) * block_tokens],
            dtype=np.int32).tobytes())
        out.append(h.digest())
    return tuple(out)


class KVStore:
    """The shared tiered prefix store (see module docstring).

    The store is pure bookkeeping over opaque block keys: residency per
    (tier, location), LRU order, pins, and in-flight writebacks. All byte
    sizing comes from ``bytes_per_token`` (the host's analytic
    ``StageProfile.kv_bytes_per_token()``), so simulation and serving
    account identically.
    """

    def __init__(self, spec: KVStoreSpec, bytes_per_token: float,
                 unit_eps: Sequence[Sequence[int]],
                 store_eps: Sequence[int] = (), *, nic_bw: float = 12.5e9):
        spec.pooled_tier()             # validates via __post_init__ already
        if spec.pooled_tier() is not None and not store_eps:
            raise ValueError("a pooled tier needs dedicated store endpoints")
        self.spec = spec
        self.bytes_per_token = float(bytes_per_token)
        self.block_bytes = spec.block_tokens * self.bytes_per_token
        self.unit_eps = [list(e) for e in unit_eps]
        self.store_eps = list(store_eps)
        self.nic_bw = nic_bw

        #: key -> set of (tier_idx, loc) placements holding a copy
        self.blocks: Dict[Hashable, Set[Tuple[int, int]]] = {}
        #: (tier_idx, loc) -> LRU-ordered resident keys (oldest first)
        self._lru: Dict[Tuple[int, int], OrderedDict] = {}
        self._used: Dict[Tuple[int, int], float] = {}
        self._pins: Dict[Hashable, int] = {}
        self._rid_pins: Dict[int, List[Hashable]] = {}
        self._chain_of: Dict[int, Tuple[Hashable, ...]] = {}
        #: fid -> (keys, tier_idx, loc) for in-flight writebacks
        self._wb: Dict[int, Tuple[Tuple[Hashable, ...], int, int]] = {}
        self._wb_keys: Set[Tuple[Hashable, int, int]] = set()
        #: per-block resolve popularity driving hot replication, stored as
        #: (EWMA count, last-update time) so decay is applied lazily
        self._pop: Dict[Hashable, Tuple[float, float]] = {}
        #: replication target: the first unit-scoped writeback tier (DRAM)
        self._hot_tier: Optional[int] = next(
            (i for i, t in enumerate(spec.tiers)
             if t.scope == "unit" and t.writeback), None)

        self.stats: Dict[str, float] = {
            "lookups": 0, "hits": 0, "hit_tokens": 0, "lookup_tokens": 0,
            "admitted_blocks": 0, "evictions": 0, "failed_inserts": 0,
            "wb_flows": 0, "wb_bytes": 0.0, "wb_done": 0,
            "hot_push_flows": 0, "hot_push_bytes": 0.0,
        }
        for t in spec.tiers:
            self.stats[f"hit_tokens_{t.name}"] = 0
        # contended-link class accounting (sampled by the runtime's tick)
        self._watched: Tuple[int, ...] = tuple(
            l for ep in ([e for eps in self.unit_eps for e in eps]
                         + self.store_eps)
            for l in (2 * ep, 2 * ep + 1))
        self._contended: Dict[str, float] = {}
        self._last_sample: Optional[float] = None

    # ------------------------------------------------------------- placement
    def _tl(self, tier_idx: int, loc: int) -> Tuple[int, int]:
        key = (tier_idx, loc)
        if key not in self._lru:
            self._lru[key] = OrderedDict()
            self._used[key] = 0.0
        return key

    def _rank(self, tl: Tuple[int, int], unit: int) -> Tuple[int, int]:
        """Placement preference for a request served on ``unit``: local
        copies first (any tier beats a network fetch), then tier order."""
        tier_idx, loc = tl
        tier = self.spec.tiers[tier_idx]
        local = 0 if (tier.scope == "unit" and loc == unit) else 1
        return (local, tier_idx)

    def _touch(self, key: Hashable, tl: Tuple[int, int]) -> None:
        lru = self._lru.get(tl)
        if lru is not None and key in lru:
            lru.move_to_end(key)

    def _insert(self, key: Hashable, tier_idx: int, loc: int) -> bool:
        """Place a copy of ``key`` in (tier, loc), evicting LRU unpinned
        blocks until it fits. Returns False if capacity cannot be made
        (every resident block is pinned by an in-flight transfer)."""
        tl = self._tl(tier_idx, loc)
        lru = self._lru[tl]
        if key in lru:
            lru.move_to_end(key)
            return True
        cap = self.spec.tiers[tier_idx].capacity
        if cap > 0:
            if self.block_bytes > cap:
                self.stats["failed_inserts"] += 1
                return False
            while self._used[tl] + self.block_bytes > cap:
                victim = next((k for k in lru if not self._pins.get(k)), None)
                if victim is None:
                    self.stats["failed_inserts"] += 1
                    return False
                del lru[victim]
                self._used[tl] -= self.block_bytes
                pls = self.blocks.get(victim)
                if pls is not None:
                    pls.discard(tl)
                    if not pls:
                        del self.blocks[victim]
                self.stats["evictions"] += 1
        lru[key] = True
        self._used[tl] += self.block_bytes
        self.blocks.setdefault(key, set()).add(tl)
        self.stats["admitted_blocks"] += 1
        return True

    def _pin(self, key: Hashable, rid: Optional[int] = None) -> None:
        self._pins[key] = self._pins.get(key, 0) + 1
        if rid is not None:
            self._rid_pins.setdefault(rid, []).append(key)

    def _unpin(self, key: Hashable) -> None:
        n = self._pins.get(key, 0) - 1
        if n > 0:
            self._pins[key] = n
        else:
            self._pins.pop(key, None)

    # ----------------------------------------------------------- popularity
    def _pop_value(self, key: Hashable, now: float) -> float:
        """Current (decayed) popularity of a block. With ``hot_halflife``
        set, the recorded count halves per elapsed half-life since its last
        update (lazy EWMA — nothing scans the whole table); 0 keeps the
        raw lifetime count."""
        ent = self._pop.get(key)
        if ent is None:
            return 0.0
        val, ts = ent
        hl = self.spec.hot_halflife
        if hl > 0 and now > ts:
            val *= 0.5 ** ((now - ts) / hl)
        return val

    def _bump_pop(self, key: Hashable, now: float) -> None:
        self._pop[key] = (self._pop_value(key, now) + 1.0, now)

    # ------------------------------------------------------------ resolution
    def peek_affinity(self, keys: Sequence[Hashable], max_tokens: int,
                      n_units: int) -> List[int]:
        """Per-unit locally-resident tokens along the chain's leading hit
        run (read-only: no LRU touch, no pins) — the routing affinity."""
        bt = self.spec.block_tokens
        aff = [0] * n_units
        for key in keys[:max(0, max_tokens) // bt]:
            pls = self.blocks.get(key)
            if not pls:
                break
            # one credit per block per unit, however many local tiers hold
            # a copy — affinity measures resident tokens, not copies
            units = {loc for tier_idx, loc in pls
                     if self.spec.tiers[tier_idx].scope == "unit"
                     and 0 <= loc < n_units}
            for u in units:
                aff[u] += bt
        return aff

    def resolve(self, keys: Sequence[Hashable], max_tokens: int, unit: int,
                rid: int, now: float = 0.0) -> HitPlan:
        """Longest resident chain prefix as a per-tier/per-owner block plan.

        Resolution happens against live state *now*: the hit walks leading
        blocks while resident, capped at ``max_tokens`` (callers pass
        ``prompt_len - 1`` so at least one suffix token is always
        computed). Chosen placements are LRU-touched and pinned for ``rid``
        until admission (:meth:`admit`) or :meth:`release`.
        """
        keys = tuple(keys)
        self._chain_of[rid] = keys
        bt = self.spec.block_tokens
        self.stats["lookups"] += 1
        self.stats["lookup_tokens"] += len(keys) * bt
        runs: List[List] = []          # [tier_idx, loc, n_blocks]
        tokens = 0
        for key in keys[:max(0, max_tokens) // bt]:
            pls = self.blocks.get(key)
            if not pls:
                break
            self._bump_pop(key, now)                     # replication signal
            tl = min(pls, key=lambda t: self._rank(t, unit))
            self._touch(key, tl)
            self._pin(key, rid)
            if runs and runs[-1][0] == tl[0] and runs[-1][1] == tl[1]:
                runs[-1][2] += 1
            else:
                runs.append([tl[0], tl[1], 1])
            tokens += bt
        if tokens:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += tokens
        segs = []
        for tier_idx, loc, n_blocks in runs:
            tier = self.spec.tiers[tier_idx]
            src_eps = tuple(self.store_eps) if tier.scope == "pooled" \
                else tuple(self.unit_eps[loc])
            segs.append(HitSegment(
                tier=tier.name, tier_idx=tier_idx, loc=loc,
                tokens=n_blocks * bt, src_eps=src_eps,
                tier_cap=tier.fetch_bw if tier.fetch_bw > 0 else None))
            self.stats[f"hit_tokens_{tier.name}"] += n_blocks * bt
        return HitPlan(tokens=tokens, segments=tuple(segs))

    def release(self, rid: int) -> None:
        """Drop every pin ``rid`` holds (prefill finished, request pruned
        away, or its decode session was evicted — the blocks themselves
        stay resident and reusable)."""
        for key in self._rid_pins.pop(rid, ()):
            self._unpin(key)
        self._chain_of.pop(rid, None)

    # -------------------------------------------------------------- admission
    def admit(self, item: Any, now: float,
              keep_pins: bool = False) -> List[Flow]:
        """Admission on prefill completion: the request's chain blocks are
        now materialised on the producing unit, so they enter the origin
        (HBM) tier immediately and a Stage-``WB`` replication flow is
        emitted toward every ``writeback`` tier that lacks a copy. WB
        deadlines are loose and *derived*: ``wb_deadline_scale`` times the
        tier-bandwidth transfer time — late enough that MFS can defer them
        below D2D, early enough that EDF-style policies chase them.

        ``keep_pins=True`` (set by the runtime when a decode plane is
        attached) carries the hit pins into the decode phase — the live
        session still references its prefix blocks, so eviction must not
        reclaim them until the decode plane releases the request
        (:meth:`release` on session finish/eviction)."""
        rid = item.rid
        keys = self._chain_of.pop(rid, ())
        if not keep_pins:
            for key in self._rid_pins.pop(rid, ()):
                self._unpin(key)
        if not keys:
            return []
        u = item.unit
        for key in keys:
            self._insert(key, 0, u)
        flows: List[Flow] = []
        for tier_idx, tier in enumerate(self.spec.tiers):
            if not tier.writeback:
                continue
            loc = u if tier.scope == "unit" else -1
            new = tuple(k for k in keys
                        if (tier_idx, loc) not in self.blocks.get(k, ())
                        and (k, tier_idx, loc) not in self._wb_keys)
            if not new:
                continue
            for k in new:
                self._pin(k)
                self._wb_keys.add((k, tier_idx, loc))
            size = len(new) * self.block_bytes
            ueps = self.unit_eps[u]
            src = ueps[rid % len(ueps)]
            dst = src if tier.scope == "unit" \
                else self.store_eps[rid % len(self.store_eps)]
            ref_bw = tier.fetch_bw if tier.fetch_bw > 0 else self.nic_bw
            f = Flow(new_flow_id(), rid, u, Stage.WB, size, src=src, dst=dst,
                     target_layer=0, n_layers=1,
                     deadline=now + self.spec.wb_deadline_scale
                     * size / ref_bw)
            f.tier_cap = tier.fetch_bw if tier.fetch_bw > 0 else None
            self._wb[f.fid] = (new, tier_idx, loc)
            self.stats["wb_flows"] += 1
            self.stats["wb_bytes"] += size
            flows.append(f)
        flows.extend(self._replicate_hot(keys, u, rid, now))
        return flows

    def on_wb_done(self, flow: Flow) -> List[Flow]:
        """A writeback landed: its blocks become resident in the target
        tier (evicting LRU blocks there as needed) and are unpinned.
        Returns follow-on hot-block replication flows (empty unless
        ``hot_threshold`` is set and the landed blocks are hot) for the
        runtime to submit."""
        entry = self._wb.pop(flow.fid, None)
        if entry is None:
            return []
        keys, tier_idx, loc = entry
        for k in keys:
            self._wb_keys.discard((k, tier_idx, loc))
            self._unpin(k)
            self._insert(k, tier_idx, loc)
        self.stats["wb_done"] += 1
        src_unit = loc if (0 <= loc < len(self.unit_eps)
                           and self.spec.tiers[tier_idx].scope == "unit") \
            else flow.unit
        return self._replicate_hot(keys, src_unit, flow.rid,
                                   flow.created if flow.finished is None
                                   else flow.finished)

    # ---------------------------------------------------- hot replication
    def _units_with_copy(self, key: Hashable) -> Set[int]:
        return {loc for tier_idx, loc in self.blocks.get(key, ())
                if self.spec.tiers[tier_idx].scope == "unit"}

    def _replicate_hot(self, keys: Sequence[Hashable], src_unit: int,
                       rid: int, now: float) -> List[Flow]:
        """Popularity-driven push of hot chain blocks toward more units'
        DRAM: every key resolved ≥ ``hot_threshold`` times gets copies
        pushed (one Stage-``WB`` flow per target unit, loose derived
        deadline like any writeback) until ``hot_copies`` units hold one
        locally — the victim unit stops being every sibling request's only
        Stage-1 source."""
        spec = self.spec
        tier_idx = self._hot_tier
        if spec.hot_threshold <= 0 or tier_idx is None \
                or not (0 <= src_unit < len(self.unit_eps)):
            return []
        tier = spec.tiers[tier_idx]
        per_unit: Dict[int, List[Hashable]] = {}
        for k in keys:
            if self._pop_value(k, now) < spec.hot_threshold:
                continue
            holders = self._units_with_copy(k)
            if src_unit not in holders:
                continue                     # push only what we can source
            # in-flight pushes count toward the copy target, or concurrent
            # hot admissions would overshoot hot_copies while one lands
            inflight = {u for u in range(len(self.unit_eps))
                        if (k, tier_idx, u) in self._wb_keys}
            want = spec.hot_copies - len(holders | inflight)
            if want <= 0:
                continue
            # deterministic target order: walk units from src_unit + 1
            for off in range(1, len(self.unit_eps)):
                if want <= 0:
                    break
                u = (src_unit + off) % len(self.unit_eps)
                if u in holders or u in inflight:
                    continue
                per_unit.setdefault(u, []).append(k)
                want -= 1
        flows: List[Flow] = []
        for u, ks in sorted(per_unit.items()):
            for k in ks:
                self._pin(k)
                self._wb_keys.add((k, tier_idx, u))
            size = len(ks) * self.block_bytes
            src = self.unit_eps[src_unit][rid % len(self.unit_eps[src_unit])]
            dst = self.unit_eps[u][rid % len(self.unit_eps[u])]
            ref_bw = tier.fetch_bw if tier.fetch_bw > 0 else self.nic_bw
            f = Flow(new_flow_id(), rid, src_unit, Stage.WB, size,
                     src=src, dst=dst, target_layer=0, n_layers=1,
                     deadline=now + spec.wb_deadline_scale * size / ref_bw)
            f.tier_cap = tier.fetch_bw if tier.fetch_bw > 0 else None
            self._wb[f.fid] = (tuple(ks), tier_idx, u)
            self.stats["wb_flows"] += 1
            self.stats["wb_bytes"] += size
            self.stats["hot_push_flows"] += 1
            self.stats["hot_push_bytes"] += size
            flows.append(f)
        return flows

    # ------------------------------------------------------------ calibration
    def steady_state_reuse(self, entries: Sequence[Tuple[Sequence[Hashable],
                                                         int]]) -> List[int]:
        """Expected per-request hit tokens at steady state, for store-aware
        SLO calibration. Replays the chains in arrival order through a
        *shadow* capacity-bounded LRU over the store's total byte capacity
        (unit tiers × locations + the pooled tier): a request's expected
        hit is its chain's leading run of previously-admitted, still-
        resident blocks. Read-only — live store state, pins and stats are
        untouched, and the replay ignores placement/tier detail (the base
        only needs the expected hit *length*)."""
        total_cap, uncapped = 0.0, False
        for t in self.spec.tiers:
            if t.capacity <= 0:
                uncapped = True
                continue
            total_cap += t.capacity * (len(self.unit_eps)
                                       if t.scope == "unit" else 1)
        max_blocks = float("inf") if uncapped \
            else int(total_cap // max(self.block_bytes, 1e-9))
        bt = self.spec.block_tokens
        seen: OrderedDict = OrderedDict()
        out: List[int] = []
        for keys, max_tokens in entries:
            hit = 0
            for key in keys[:max(0, max_tokens) // bt]:
                if key not in seen:
                    break
                hit += bt
                seen.move_to_end(key)
            out.append(min(hit, max(0, max_tokens)))
            for key in keys:
                if key in seen:
                    seen.move_to_end(key)
                else:
                    seen[key] = True
                    if len(seen) > max_blocks:
                        seen.popitem(last=False)
        return out

    # ----------------------------------------------------------- observation
    def sample_contention(self, net: Any, now: float,
                          max_dt: Optional[float] = None) -> None:
        """Accumulate per-stage allocated rate x time on *contended* watched
        links (NIC up/down of the prefill units and store nodes at >= 90%
        utilisation) — the basis for the WB-share-under-contention metric
        the benchmarks report. Called from the runtime's periodic tick;
        ``max_dt`` caps the credited interval so an idle gap (ticks stop
        when nothing is in flight) is never attributed to the traffic that
        happens to be allocated when sampling resumes."""
        if self._last_sample is None:
            self._last_sample = now
            return
        dt = now - self._last_sample
        self._last_sample = now
        if dt <= 0:
            return
        if max_dt is not None and dt > max_dt:
            dt = max_dt
        for lid in self._watched:
            cap = net.topo.capacity.get(lid)
            if not cap:
                continue
            if net._link_rate.get(lid, 0.0) < 0.9 * cap:
                continue
            for stage, rate in net.class_rates(lid).items():
                name = stage.name
                self._contended[name] = self._contended.get(name, 0.0) \
                    + rate * dt
        return

    def wb_share_contended(self) -> float:
        tot = sum(self._contended.values())
        return self._contended.get("WB", 0.0) / tot if tot > 0 else 0.0

    def resident_bytes(self, tier_name: Optional[str] = None) -> float:
        out = 0.0
        for (tier_idx, _), used in self._used.items():
            if tier_name is None \
                    or self.spec.tiers[tier_idx].name == tier_name:
                out += used
        return out

    def summary(self) -> Dict[str, float]:
        s = dict(self.stats)
        s["hit_rate_tokens"] = self.stats["hit_tokens"] \
            / max(self.stats["lookup_tokens"], 1)
        for t in self.spec.tiers:
            s[f"resident_bytes_{t.name}"] = self.resident_bytes(t.name)
        s["wb_inflight"] = len(self._wb)
        s["wb_share_contended"] = self.wb_share_contended()
        s["pinned_blocks"] = len(self._pins)
        return s


# ------------------------------------------------------------ shared routing
def kv_route(store: KVStore, keys: Sequence[Hashable], max_tokens: int,
             backlogs: Sequence[float], rid: int,
             now: float = 0.0) -> Tuple[int, HitPlan]:
    """Cache-aware routing: score every unit by hit-weighted affinity
    (tokens resident locally along the chain's leading run) against its
    token backlog — the same 2:1 weighting the static-oracle router used —
    then resolve the winner's block plan against live store state.

    Kept as a standalone helper for direct store-level callers and tests;
    the hosts now route through the pluggable router plane
    (``repro.core.router.KVAffinityRouter`` + the runtime's resolve step),
    which reproduces this function's store-op sequence exactly."""
    aff = store.peek_affinity(keys, max_tokens, len(backlogs))
    best, best_score = 0, -float("inf")
    for u in range(len(backlogs)):
        score = 2.0 * aff[u] - backlogs[u]
        if score > best_score:
            best, best_score = u, score
    plan = store.resolve(keys, max_tokens, best, rid, now=now)
    return best, plan
