"""Priority-aware fluid (rate-based) flow model — the flowsim analogue.

Bandwidth allocation semantics (matching §5's enforcement model):

  1. Active flows are grouped by ``priority_key`` (lexicographic tuples,
     smaller = more urgent) and groups are served in **strict priority**
     order: a group only sees the capacity left over by more urgent groups.
  2. Within a group, bandwidth is **max-min fair** (progressive filling),
     honouring per-flow ``rate_cap`` ceilings (Karuna-style pacing).
  3. Flows whose route is empty (same-endpoint transfers) complete at the
     memory-copy rate ``LOCAL_BW``.

Between events rates are constant, so completion times are exact; the event
loop re-allocates whenever the active set, keys or caps change. This is the
standard fluid approximation used by flow-level simulators (flowsim, Sincronia,
Karuna) — per-packet effects (reordering etc.) are *designed out* of MFS by
message-atomic promotion, so the fluid model is faithful for this paper.

Scaling to paper-sized sweeps (thousands of requests, fat-tree fabrics) rests
on two structural properties of the model, exploited incrementally:

* **Dirty-group reallocation.** A priority group's water-filling fixpoint is a
  pure function of (member set, member rate caps, member routes, residual
  capacity left by more-urgent groups). ``reallocate`` therefore caches, per
  group, the allocation together with the residuals it consumed, and re-runs
  the fill only for groups whose signature or input residuals changed since
  the previous epoch; clean groups replay their cached link usage verbatim,
  which keeps the produced rates bit-identical to a from-scratch allocation
  (asserted by ``tests/test_netsim.py::test_incremental_matches_full``).
* **Lazy-invalidation completion heap.** Between reallocations every flow
  drains linearly, so its *absolute* completion time is invariant; it only
  moves when the flow's rate changes. ``next_completion`` keeps a heap of
  (predicted_t, fid, version) entries pushed on every rate change and skips
  stale entries (version mismatch / flow gone) on pop, replacing the
  per-event O(flows) scan.
* **Warm-started within-group fills.** The wide single-key group (FairShare
  / shared RMLQ bands) churns membership on every completion, so its
  route-incidence matrix was rebuilt from per-flow route walks each fill.
  ``_vec_struct`` seeds the fill from the previous fixpoint's structure and
  patches columns (survivors kept, departures dropped, arrivals appended),
  leaving the fill arithmetic — integer incidence sums, order-independent
  mins — bit-identical to a cold build (``waterfill.warmstart.*``
  microbench rows + tests/test_netsim.py assert this).
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.msflow import Flow, FlowState, Stage
from .topology import Topology

__all__ = ["FluidNet", "LOCAL_BW"]

LOCAL_BW = 2e12      # same-endpoint "transfer" drains at HBM-copy speed
_EPS = 1e-12         # rate/capacity epsilon
_EPS_BYTES = 1e-4    # a flow with less than this many bytes left is done


def _eff_cap(f: Flow) -> Optional[float]:
    """Effective per-flow ceiling: the policy-assigned ``rate_cap`` combined
    with the immutable storage-tier fetch ceiling ``tier_cap`` (KV-reuse
    plane). Policies overwrite ``rate_cap`` every assign; the tier ceiling
    survives regardless."""
    if f.tier_cap is None:
        return f.rate_cap
    if f.rate_cap is None:
        return f.tier_cap
    return min(f.rate_cap, f.tier_cap)


class _VecStruct:
    """Warm-started incidence structure for one wide priority group.

    The route-incidence matrix ``A[link, flow]`` (and its transpose) is the
    per-fill setup cost of the vectorized water-fill; membership of the wide
    single-key group churns on every completion, so rebuilding it from
    per-flow route walks dominates. The structure is seeded from the
    previous fill and *patched* — surviving columns are kept (C-speed
    slicing), departed columns dropped, new columns appended — which leaves
    every retained 0/1 entry, and therefore every float the fill computes,
    identical to a from-scratch build: integer-valued incidence sums and
    order-independent mins make the warm-started rates bit-identical
    (asserted in tests/test_netsim.py::test_warmstart_matches_cold).
    Rows of links no longer used by any member stay as all-zero rows (no
    arithmetic effect); the structure is rebuilt once they dominate.
    """

    __slots__ = ("fids", "lids", "lidx", "A", "AT")

    def __init__(self, fids, lids, lidx, A):
        self.fids = fids
        self.lids = lids
        self.lidx = lidx
        self.A = A
        self.AT = np.ascontiguousarray(A.T)


class _GroupAlloc:
    """Cached water-filling result for one priority group.

    ``sig`` is the (fid, rate_cap) tuple of the members in iteration order;
    ``res_in``/``res_out`` map each link the group's routes touch to the
    residual capacity before/after the fill. A cached entry may be replayed
    iff ``sig`` and ``res_in`` are unchanged — then the exact ``res_out``
    floats are restored (NOT a usage sum re-subtracted, which would drift at
    the ulp level) and every member keeps its current rate, so downstream
    groups observe residuals bit-identical to a from-scratch allocation.
    """

    __slots__ = ("sig", "res_in", "res_out")

    def __init__(self, sig, res_in, res_out):
        self.sig = sig
        self.res_in = res_in
        self.res_out = res_out


class FluidNet:
    def __init__(self, topo: Topology, incremental: bool = True):
        self.topo = topo
        self.flows: Dict[int, Flow] = {}
        self.routes: Dict[int, Tuple[int, ...]] = {}
        self.now = 0.0
        #: dirty-group caching toggle (off = every group fills every epoch)
        self.incremental = incremental
        self._link_rate: Dict[int, float] = {}      # post-allocation usage
        self._members: Dict[int, List[Flow]] = {}   # built lazily on demand
        self._members_stale = True
        self._galloc: Dict[Tuple, _GroupAlloc] = {}
        # lazy-invalidation completion heap: (t_pred, seq, fid, version)
        self._pred_heap: List[Tuple[float, int, int, int]] = []
        self._pred_version: Dict[int, int] = {}
        self._pred_seq = itertools.count()
        #: warm-started within-group fills: cache + toggle (rates are
        #: bit-identical either way; off = rebuild incidence every fill)
        self.warmstart = True
        self._vec_cache: Dict[Tuple, _VecStruct] = {}
        #: instrumentation for the incremental-allocation microbenches
        self.stats = {"reallocs": 0, "group_fills": 0, "groups_seen": 0,
                      "vec_builds": 0, "vec_patches": 0}

    # ------------------------------------------------------------- lifecycle
    def add(self, flow: Flow) -> None:
        self.flows[flow.fid] = flow
        self.routes[flow.fid] = self.topo.route(flow.src, flow.dst, flow.fid)
        flow.state = FlowState.ACTIVE if flow.state != FlowState.PRUNED else flow.state
        if flow.started is None:
            flow.started = self.now
        self._members_stale = True

    def remove(self, flow: Flow) -> None:
        """Drop a flow (completion or cancellation) and release its rate from
        the link accounting immediately — a cancelled flow must not keep
        inflating ``bottleneck`` / ``bottleneck_protected`` rho until the
        next reallocation."""
        route = self.routes.pop(flow.fid, ())
        if self.flows.pop(flow.fid, None) is not None and flow.rate > 0.0:
            for lid in route:
                left = self._link_rate.get(lid, 0.0) - flow.rate
                self._link_rate[lid] = left if left > _EPS else 0.0
        flow.rate = 0.0
        self._pred_version.pop(flow.fid, None)
        self._members_stale = True

    def set_rate(self, flow: Flow, rate: float) -> None:
        """Directly assign a rate outside the water-filling path (used by the
        runtime's contention-free mode). Keeps the completion heap coherent
        and drops the group caches, which the assignment bypassed."""
        self._galloc = {}
        self._assign_rate(flow, rate)

    def advance(self, t: float) -> List[Flow]:
        """Progress all flows to time ``t`` at current rates; return the flows
        that completed (remaining hits zero) in this interval."""
        dt = t - self.now
        if dt < -1e-9:
            raise ValueError(f"time went backwards: {self.now} -> {t}")
        done: List[Flow] = []
        for f in self.flows.values():
            if dt > 0 and f.rate > 0.0:
                f.remaining = max(0.0, f.remaining - f.rate * dt)
            # float-safe completion: anything within a sub-byte epsilon (or
            # within one picosecond of draining at the current rate) is done —
            # prevents completion-prediction livelock at time resolution.
            if f.remaining <= max(_EPS_BYTES, f.rate * 1e-12):
                f.remaining = 0.0
                done.append(f)
        self.now = t
        for f in done:
            f.state = FlowState.DONE
            f.finished = t
            self.remove(f)          # zeroes rate + releases link accounting
        return done

    # ------------------------------------------------------------ allocation
    def reallocate(self, full: bool = False) -> None:
        """Strict-priority, per-group max-min water-filling with rate caps.

        Incremental: groups whose member signature and input residuals match
        the cached epoch replay their allocation without re-filling. Pass
        ``full=True`` (or construct with ``incremental=False``) to force a
        from-scratch fill of every group — rates are identical either way.
        """
        self.stats["reallocs"] += 1
        residual = dict(self.topo.capacity)
        groups: Dict[Tuple, List[Flow]] = {}
        for f in self.flows.values():
            groups.setdefault(tuple(f.priority_key), []).append(f)
        self.stats["groups_seen"] += len(groups)
        cache = self._galloc if (self.incremental and not full) else {}
        galloc: Dict[Tuple, _GroupAlloc] = {}
        for key in sorted(groups):
            members = groups[key]
            sig = tuple((f.fid, f.rate_cap) for f in members)
            cached = cache.get(key)
            if (cached is not None and cached.sig == sig
                    and all(residual[lid] == r
                            for lid, r in cached.res_in.items())):
                # clean replay: members already hold these rates; restore the
                # cached post-fill residuals exactly
                residual.update(cached.res_out)
                galloc[key] = cached
                continue
            res_in: Dict[int, float] = {}
            for f in members:
                for lid in self.routes[f.fid]:
                    if lid not in res_in:
                        res_in[lid] = residual[lid]
            rate: Dict[int, float] = {}
            self._fill_group(members, residual, rate, key)
            for f in members:
                self._assign_rate(f, rate[f.fid])
            res_out = {lid: residual[lid] for lid in res_in}
            galloc[key] = _GroupAlloc(sig, res_in, res_out)
            self.stats["group_fills"] += 1
        self._galloc = galloc
        if self._vec_cache:
            # keep warm structures only for groups that still exist
            self._vec_cache = {k: v for k, v in self._vec_cache.items()
                               if k in galloc}
        self._link_rate = {lid: cap - residual[lid]
                           for lid, cap in self.topo.capacity.items()}
        self._members_stale = True

    def _assign_rate(self, f: Flow, r: float) -> None:
        """Set a flow's rate, refreshing its completion prediction iff the
        rate actually changed (linear drain keeps the absolute completion
        time invariant under an unchanged rate)."""
        if r == f.rate:
            return
        f.rate = r
        v = self._pred_version.get(f.fid, 0) + 1
        self._pred_version[f.fid] = v
        if r > 0.0:
            t = self.now + max(f.remaining / r, 1e-12)
            heapq.heappush(self._pred_heap, (t, next(self._pred_seq), f.fid, v))

    #: group size at which the numpy water-filling overtakes the dict walk
    #: (measured on FatTree(8x8): the matrix path is ~3x faster at 512
    #: flows/group but ~4x slower at <64 because of per-round numpy setup)
    VEC_THRESHOLD = 96

    def _fill_group(self, members: List[Flow], residual: Dict[int, float],
                    rate: Dict[int, float], key: Optional[Tuple] = None) -> None:
        """Water-fill one priority group into ``rate`` (fid -> rate), drawing
        down ``residual`` in place. Pure w.r.t. flow state: the caller owns
        rate assignment and link accounting."""
        routed: List[Flow] = []
        # local (routeless) flows drain immediately at LOCAL_BW (or their
        # per-flow ceiling — a host-local tier writeback pays its tier bw)
        for f in members:
            if not self.routes[f.fid]:
                cap = _eff_cap(f)
                rate[f.fid] = LOCAL_BW if cap is None \
                    else min(LOCAL_BW, cap)
            else:
                routed.append(f)
        if len(routed) >= self.VEC_THRESHOLD:
            self._waterfill_vec(routed, residual, rate, key)
        elif routed:
            self._waterfill_scalar(routed, residual, rate)

    def _waterfill_scalar(self, routed: List[Flow], residual: Dict[int, float],
                          rate: Dict[int, float]) -> None:
        """Progressive filling with per-flow dict walks — wins for the small
        groups produced by per-flow priority keys (SJF, EDF tie-breaks)."""
        unfrozen = {f.fid: f for f in routed}
        for f in routed:
            rate[f.fid] = 0.0
        while unfrozen:
            # population of unfrozen flows per link
            nflows: Dict[int, int] = {}
            for fid in unfrozen:
                for lid in self.routes[fid]:
                    nflows[lid] = nflows.get(lid, 0) + 1
            # smallest incremental fair share over saturating constraints
            inc = math.inf
            for lid, n in nflows.items():
                inc = min(inc, max(0.0, residual[lid]) / n)
            for fid, f in unfrozen.items():
                cap = _eff_cap(f)
                if cap is not None:
                    inc = min(inc, cap - rate[fid])
            if inc < 0:
                inc = 0.0
            if not math.isfinite(inc):
                break
            for fid in unfrozen:
                rate[fid] += inc
                for lid in self.routes[fid]:
                    residual[lid] -= inc
            # freeze: flows at cap, flows crossing a saturated link
            newly_frozen = []
            for fid, f in unfrozen.items():
                cap = _eff_cap(f)
                at_cap = cap is not None and rate[fid] >= cap - _EPS
                saturated = any(residual[lid] <= _EPS for lid in self.routes[fid])
                if at_cap or saturated:
                    newly_frozen.append(fid)
            if not newly_frozen:      # numerical guard: freeze everything
                break
            for fid in newly_frozen:
                del unfrozen[fid]

    def _build_struct(self, routed: List[Flow]) -> _VecStruct:
        lids = sorted({lid for f in routed for lid in self.routes[f.fid]})
        lidx = {lid: i for i, lid in enumerate(lids)}
        A = np.zeros((len(lids), len(routed)))
        for j, f in enumerate(routed):
            for lid in self.routes[f.fid]:
                A[lidx[lid], j] = 1.0
        self.stats["vec_builds"] += 1
        return _VecStruct([f.fid for f in routed], lids, lidx, A)

    def _vec_struct(self, routed: List[Flow],
                    key: Optional[Tuple]) -> _VecStruct:
        """Incidence structure for a vectorized fill: seeded from the
        previous fixpoint's structure when only membership churned (see
        :class:`_VecStruct`), rebuilt from the members' routes otherwise."""
        if not self.warmstart or key is None:
            return self._build_struct(routed)
        fids = [f.fid for f in routed]
        cached = self._vec_cache.get(key)
        if cached is not None and cached.fids == fids:
            return cached
        struct = None
        if cached is not None:
            old = set(cached.fids)
            new = set(fids)
            kept = [j for j, fid in enumerate(cached.fids) if fid in new]
            added = [f for f in routed if f.fid not in old]
            # the patch only applies when survivors kept their relative
            # order and newcomers trail (how dict-ordered churn behaves);
            # anything else — e.g. a re-keyed flow landing mid-group —
            # falls back to a full rebuild
            if [cached.fids[j] for j in kept] + [f.fid for f in added] == fids:
                A = cached.A[:, kept] if len(kept) != len(cached.fids) \
                    else cached.A
                lids, lidx = cached.lids, cached.lidx
                newlinks = []
                for f in added:
                    for lid in self.routes[f.fid]:
                        if lid not in lidx and lid not in newlinks:
                            newlinks.append(lid)
                if newlinks:
                    lids = lids + newlinks
                    lidx = dict(lidx)
                    for lid in newlinks:
                        lidx[lid] = len(lidx)
                    A = np.vstack([A, np.zeros((len(newlinks), A.shape[1]))])
                if added:
                    cols = np.zeros((len(lids), len(added)))
                    for j, f in enumerate(added):
                        for lid in self.routes[f.fid]:
                            cols[lidx[lid], j] = 1.0
                    A = np.hstack([A, cols])
                # prune rows of links no member uses anymore: keeps every
                # round's matmul at live-link size (an absent row has no
                # arithmetic effect, so rates stay bit-identical)
                live = A.any(axis=1)
                if not live.all():
                    A = A[live]
                    lids = [lid for lid, keep in zip(lids, live) if keep]
                    lidx = {lid: i for i, lid in enumerate(lids)}
                self.stats["vec_patches"] += 1
                struct = _VecStruct(fids, lids, lidx, A)
        if struct is None:
            struct = self._build_struct(routed)
        self._vec_cache[key] = struct
        return struct

    def _waterfill_vec(self, routed: List[Flow], residual: Dict[int, float],
                       rate: Dict[int, float],
                       key: Optional[Tuple] = None) -> None:
        """Progressive filling over the group's route-incidence matrix
        A[link, flow]: each round raises every unfrozen flow by the smallest
        constraint (fair share of the tightest link, or the nearest rate
        cap), then freezes flows at cap or on a saturated link — the same
        fixpoint as the scalar walk, in O(rounds) vector ops. Wins for the
        wide single-key groups of FairShare and shared RMLQ bands. The
        incidence structure is warm-started across fills (``key`` selects
        the cache slot); rates stay bit-identical to a cold build."""
        struct = self._vec_struct(routed, key)
        lids, lidx, A, AT = struct.lids, struct.lidx, struct.A, struct.AT
        res = np.array([residual[lid] for lid in lids])
        caps = np.array([math.inf if (c := _eff_cap(f)) is None else c
                         for f in routed])
        rates = np.zeros(len(routed))
        active = np.ones(len(routed))
        while True:
            counts = A @ active
            used = counts > 0.0
            # smallest incremental fair share over saturating constraints
            share = np.where(used, np.maximum(res, 0.0)
                             / np.where(used, counts, 1.0), math.inf)
            headroom = np.where(active > 0.0, caps - rates, math.inf)
            inc = min(share.min(initial=math.inf),
                      headroom.min(initial=math.inf))
            if inc < 0:
                inc = 0.0
            if not math.isfinite(inc):
                break
            rates += active * inc
            res -= counts * inc
            # freeze: flows at cap, flows crossing a saturated link
            newly = active * (((rates >= caps - _EPS)
                               | (AT @ (res <= _EPS) > 0.0)))
            if not newly.any():       # numerical guard: freeze everything
                break
            active -= newly
            if not active.any():
                break
        for lid, i in lidx.items():
            residual[lid] = float(res[i])
        for j, f in enumerate(routed):
            rate[f.fid] = float(rates[j])

    # --------------------------------------------------------------- queries
    def next_completion(self) -> Optional[Tuple[float, Flow]]:
        """Earliest predicted flow completion under current rates.

        Heap entries are invalidated lazily: an entry is live only if its
        flow still exists, still transmits, and its rate has not changed
        since the entry was pushed (version match). Stale entries are popped
        on the way to the top; a periodic rebuild bounds heap growth."""
        heap = self._pred_heap
        if len(heap) > 4 * len(self.flows) + 64:
            self._rebuild_predictions()
            heap = self._pred_heap
        while heap:
            t, _, fid, v = heap[0]
            f = self.flows.get(fid)
            if f is None or f.rate <= 0.0 or self._pred_version.get(fid) != v:
                heapq.heappop(heap)
                continue
            return t, f
        return None

    def _rebuild_predictions(self) -> None:
        self._pred_heap = []
        for f in self.flows.values():
            v = self._pred_version.get(f.fid, 0)
            if f.rate > 0.0:
                t = self.now + max(f.remaining / f.rate, 1e-12)
                heapq.heappush(self._pred_heap,
                               (t, next(self._pred_seq), f.fid, v))

    def _link_members(self, lid: int) -> List[Flow]:
        if self._members_stale:
            self._members = {}
            for f in self.flows.values():
                for l in self.routes[f.fid]:
                    self._members.setdefault(l, []).append(f)
            self._members_stale = False
        return self._members.get(lid, [])

    def bottleneck(self, flow: Flow) -> Tuple[float, float]:
        """(capacity, rho) of the flow's most-utilised path link, excluding
        the flow's own contribution — feeds the MLU computation (§4.3)."""
        route = self.routes.get(flow.fid)
        if route is None:
            route = self.topo.route(flow.src, flow.dst, flow.fid)
        if not route:
            return LOCAL_BW, 0.0
        best_cap, best_rho = None, -1.0
        for lid in route:
            cap = self.topo.capacity[lid]
            used = self._link_rate.get(lid, 0.0) - (flow.rate if flow.fid in self.flows else 0.0)
            rho = min(1.0, max(0.0, used / cap))
            if rho > best_rho or (rho == best_rho and (best_cap is None or cap < best_cap)):
                best_cap, best_rho = cap, rho
        return float(best_cap), float(best_rho)

    def bottleneck_protected(self, flow: Flow, predicate) -> Tuple[float, float]:
        """Like :meth:`bottleneck`, but rho only counts path traffic for which
        ``predicate(other_flow)`` holds — i.e. traffic the candidate flow is
        *not allowed to preempt*. Feeding this into MLU avoids the positive
        feedback loop where contention from equally-deferred peers inflates
        every peer's urgency simultaneously."""
        route = self.routes.get(flow.fid)
        if route is None:
            route = self.topo.route(flow.src, flow.dst, flow.fid)
        if not route:
            return LOCAL_BW, 0.0
        best_cap, best_rho = None, -1.0
        for lid in route:
            cap = self.topo.capacity[lid]
            used = sum(f.rate for f in self._link_members(lid)
                       if f.fid != flow.fid and predicate(f))
            rho = min(1.0, max(0.0, used / cap))
            if rho > best_rho or (rho == best_rho and (best_cap is None or cap < best_cap)):
                best_cap, best_rho = cap, rho
        return float(best_cap), float(best_rho)

    def utilization(self) -> Dict[int, float]:
        return {lid: self._link_rate.get(lid, 0.0) / cap
                for lid, cap in self.topo.capacity.items()}

    # ----------------------------------------------------- flow-class tagging
    def class_rates(self, lid: int) -> Dict[Stage, float]:
        """Allocated rate on one link broken down by MsFlow stage — how much
        of a shared decode downlink P2D vs D2D is actually holding."""
        out: Dict[Stage, float] = {}
        for f in self._link_members(lid):
            out[f.stage] = out.get(f.stage, 0.0) + f.rate
        return out

    def class_utilization(self, lids=None) -> Dict[Stage, float]:
        """Aggregate allocated bandwidth per stage over ``lids`` (default:
        every link). Benchmarks sample this to attribute contention on the
        shared downlinks to traffic classes."""
        out: Dict[Stage, float] = {}
        targets = set(lids) if lids is not None else None
        for f in self.flows.values():
            share = sum(1 for l in self.routes[f.fid]
                        if targets is None or l in targets)
            if share:
                out[f.stage] = out.get(f.stage, 0.0) + f.rate * share
        return out
