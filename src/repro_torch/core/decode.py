"""Decode plane — decode pools, per-token progress, and D2D KV migration.

The prefill side of the runtime ends a request at its first token (TTFT);
this module models everything after it, which is where the paper's overload
control gets its second contender: **decode-instance KV migration and
load-rebalancing transfers fight prefill P2D on the shared decode
downlinks** (§ overload control). Related work motivates the shape of the
model: *Taming Request Imbalance* attributes most disaggregated-serving SLO
violations to decode-side imbalance under variable request patterns, and
*SLOs-Serve* shows TTFT-only scheduling misallocates capacity once decode
(TPOT) SLOs coexist with prefill ones.

Pieces:

  * :class:`DecodePoolSpec` / :class:`DecodeSpec` — named multi-decode
    pools (per-tenant / per-model). Each pool owns a slice of the decode
    endpoints, a per-endpoint slot budget, a TPOT budget (the per-token
    SLO base) and optionally a pool-default TTFT ``slo_scale`` so P2D
    deadlines differ per pool.
  * :class:`DecodeSession` — one request living past its first token:
    sampled output length, per-token times (TBT gaps), migration history.
  * :class:`DecodePlane` — per-endpoint batched decode steps driven by the
    shared event queue (``dstep`` events; step latency from
    ``StageProfile.decode_step_time``), plus the **rebalancer**: when a
    pool's per-endpoint session counts diverge past a hysteresis
    high-water mark, it emits Stage-``D2D`` flows (KV migration from the
    hot endpoint to the cold one) into the same ``FluidNet`` as S1/S2/S3,
    where they share strict-priority water-filling and the decode
    downlinks with P2D traffic.

D2D deadline derivation (``d2d_deadline``): the migrated KV must arrive by
the time the *destination* owes the request its next token under the TPOT
SLO — ``max(t_first_token + tpot_budget * tokens_done, now + tpot_budget)``.
A request ahead of its per-token budget donates its accrued slack, so
loose-SLO rebalancing is exactly the traffic overload control can defer in
favor of tight-TTFT P2D (the MFS arbiter gives D2D its own band below P2D
at equal RMLQ level; baselines treat D2D by their generic rule).

Control-plane only (no JAX) and host-agnostic, like the rest of
``repro.core``: both ``ClusterSim`` and ``DisaggServer`` attach one plane
to the shared runtime, so decode event sequences are host-parity-testable
exactly like prefill stage traces.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .msflow import Flow, Stage, new_flow_id

__all__ = ["DecodePoolSpec", "DecodeSpec", "DecodeSession", "DecodePlane",
           "partition_pools"]


@dataclass(frozen=True)
class DecodePoolSpec:
    """One named decode pool (per-tenant or per-model)."""

    name: str = "default"
    weight: float = 1.0          # share of the decode endpoints
    slots_per_ep: int = 8        # concurrent decode sessions per endpoint
    tpot_budget: float = 0.05    # per-token SLO base (s/token, standard class)
    slo_scale: float = 0.0       # pool-default TTFT scale (0 = cluster-wide);
    #                              this is how P2D deadlines differ per pool
    classes: Tuple[str, ...] = ()  # SLO classes routed here ((), = weighted)


@dataclass(frozen=True)
class DecodeSpec:
    """Decode-plane configuration attached to a cluster/server spec."""

    pools: Tuple[DecodePoolSpec, ...] = (DecodePoolSpec(),)
    mean_out: int = 128          # sampled output length (lognormal mean) when
    out_sigma: float = 0.7       # the request carries no explicit out_tokens
    max_out: int = 0             # 0 = 8x mean
    standard_scale: float = 3.0  # slo_scale of the "standard" tenant class;
    #                              a request's TPOT budget = pool budget x
    #                              (its slo_scale / standard_scale)
    rebalance: bool = True
    trigger_delta: int = 4       # hysteresis high-water (max-min sessions)
    release_delta: int = 1       # hysteresis low-water (stop migrating)
    max_inflight: int = 2        # concurrent D2D migrations per pool
    min_migrate_remaining: int = 4   # don't migrate nearly-finished sessions
    # --- decode-side overload eviction (the Algorithm-1 decode loop) ---
    # When an in-flight migration's derived deadline goes infeasible (the
    # remaining KV cannot arrive in time even at the bottleneck's full
    # capacity), the plane abandons the D2D and releases its slots; loose
    # sessions spill to the bulk pool (``spill_pool``, or the loosest-budget
    # pool when empty), non-loose sessions re-queue on their source
    # endpoint, and loose sessions with nowhere to spill are evicted for
    # good (their KV blocks are released back through the KV store).
    auto_evict: bool = False
    spill_pool: str = ""


def partition_pools(pools: Sequence[DecodePoolSpec],
                    eps: Sequence[int]) -> Dict[str, List[int]]:
    """Split the decode endpoints into contiguous per-pool slices by weight
    (every pool gets at least one endpoint)."""
    eps = list(eps)
    if len(eps) < len(pools):
        raise ValueError(f"{len(pools)} pools need >= {len(pools)} decode "
                         f"endpoints, got {len(eps)}")
    wsum = sum(max(p.weight, 1e-9) for p in pools)
    out: Dict[str, List[int]] = {}
    start, acc = 0, 0.0
    for i, p in enumerate(pools):
        acc += max(p.weight, 1e-9)
        end = len(eps) if i == len(pools) - 1 else int(round(acc / wsum * len(eps)))
        end = min(max(end, start + 1), len(eps) - (len(pools) - 1 - i))
        out[p.name] = eps[start:end]
        start = end
    return out


@dataclass
class DecodeSession:
    """One request on the decode plane (created when its TTFT materialises)."""

    rid: int
    pool: str
    ep: int                      # current decode endpoint
    prompt_tokens: int
    out_tokens: int              # total output tokens incl. the first
    tpot_budget: float           # this request's per-token budget (s/token)
    started: float               # admit time == first-token time
    last_token: float
    tokens_done: int = 1         # the first token came with the prefill handoff
    finished: Optional[float] = None
    state: str = "queued"        # queued | active | migrating | done | evicted
    gap_sum: float = 0.0         # TBT bookkeeping over tokens 2..N
    gap_max: float = 0.0
    n_migrations: int = 0
    migrate_dst: int = -1
    d2d_fid: int = -1
    no_migrate: bool = False     # set after an abandoned migration so the
    #                              rebalancer cannot immediately re-pick it;
    #                              cleared once the session makes token
    #                              progress (conditions have changed)
    payload: Any = None          # the host's request object, if it wants one

    @property
    def ctx_tokens(self) -> int:
        return self.prompt_tokens + self.tokens_done

    @property
    def remaining(self) -> int:
        return self.out_tokens - self.tokens_done

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (== mean TBT)."""
        if self.tokens_done <= 1:
            return 0.0
        end = self.finished if self.finished is not None else self.last_token
        return (end - self.started) / (self.tokens_done - 1)

    @property
    def tpot_ok(self) -> bool:
        return self.tpot <= self.tpot_budget + 1e-12


class DecodePlane:
    """Decode pools + rebalancer, driven by the shared MsFlow runtime.

    The runtime owns the clock and the fluid net; the plane only reacts to
    events the runtime routes to it (``admit`` at TTFT, ``on_step`` for
    ``dstep`` events, ``on_d2d_done`` for migration completions) and submits
    D2D flows back through ``runtime._submit`` — the same primitive every
    other stage uses, so D2D contends in the exact same water-filling.
    """

    def __init__(self, spec: DecodeSpec, profile: Any,
                 pool_eps: Dict[str, List[int]], *, seed: int = 0,
                 trace: bool = False):
        self.spec = spec
        self.profile = profile
        self.pools: Dict[str, DecodePoolSpec] = {p.name: p for p in spec.pools}
        unknown = set(pool_eps) - set(self.pools)
        if unknown:
            raise ValueError(f"pool_eps names {sorted(unknown)} not in spec")
        self.pool_eps = {name: list(e) for name, e in pool_eps.items()}
        self._pool_of_ep = {ep: name for name, eps in self.pool_eps.items()
                            for ep in eps}
        self.rng = np.random.default_rng(seed)
        self.rt: Any = None                      # bound by MsFlowRuntime

        self.sessions: Dict[int, DecodeSession] = {}    # live only (O(active))
        self.active: Dict[int, Dict[int, DecodeSession]] = {
            ep: {} for eps in self.pool_eps.values() for ep in eps}
        self.queued: Dict[str, Deque[DecodeSession]] = {
            name: deque() for name in self.pools}
        self.queued_on: Dict[int, int] = {ep: 0 for ep in self.active}
        self.incoming: Dict[int, int] = {ep: 0 for ep in self.active}
        self._step_armed: Dict[int, bool] = {ep: False for ep in self.active}
        self._step_members: Dict[int, Tuple[int, ...]] = {}
        self._inflight: Dict[str, int] = {name: 0 for name in self.pools}
        self._rebalancing: Dict[str, bool] = {name: False for name in self.pools}
        self._kv_per_tok = profile.kv_bytes_per_token()
        self._state_b = profile.model.state_bytes(profile.kv_dtype_bytes)
        self._G = len(profile.plan)
        self.stats = {"admitted": 0, "finished": 0, "tokens": 0, "steps": 0,
                      "migrations": 0, "d2d_bytes": 0.0, "evicted": 0,
                      "abandoned": 0, "spilled": 0, "dropped": 0}
        self.trace = trace
        self.event_log: Deque[Tuple] = deque(maxlen=100_000)

    def bind(self, rt: Any) -> None:
        self.rt = rt

    def _log(self, kind: str, rid: int, ep: int, t: float, extra: int = 0) -> None:
        if self.trace:
            self.event_log.append((kind, rid, ep, extra, t))
        # telemetry plane: every decode-plane event funnels through here, so
        # one forward covers admit/finish/d2d/migrated/abandon/spill/evict.
        # Per-token steps are summarized by the finish event (tokens_done in
        # ``extra``) rather than flooding the per-request lifecycle.
        # plane may run unbound (or against a stub runtime) in tests
        tel = getattr(getattr(self, "rt", None), "telemetry", None)
        if tel is not None and kind != "token":
            tel.request_event(rid, "decode_" + kind,
                              {"ep": ep, "extra": extra}, t=t)

    def _release_kv(self, rid: int) -> None:
        """Release the request's KV-store pins (held through decode so the
        live session's prefix blocks cannot be evicted from under it)."""
        kv = getattr(self.rt, "kvstore", None) if self.rt is not None else None
        if kv is not None:
            kv.release(rid)

    # ------------------------------------------------------------ pool routing
    def pick_pool(self, item: Any) -> str:
        """Pool for an arriving request: class-pinned pools first (the
        per-tenant story), else a deterministic weighted hash of the rid so
        both hosts route identically."""
        cls = getattr(item.payload, "slo_class", None)
        if cls is not None:
            for p in self.pools.values():
                if cls in p.classes:
                    return p.name
        open_pools = [p for p in self.pools.values() if not p.classes]
        if not open_pools:
            open_pools = list(self.pools.values())
        wsum = sum(max(p.weight, 1e-9) for p in open_pools)
        u = ((item.rid * 2654435761) % (1 << 32)) / float(1 << 32) * wsum
        acc = 0.0
        for p in open_pools:
            acc += max(p.weight, 1e-9)
            if u < acc:
                return p.name
        return open_pools[-1].name

    def pool_slo_scale(self, pool: str) -> float:
        """Pool-default TTFT scale (0 defers to the cluster-wide default)."""
        p = self.pools.get(pool)
        return p.slo_scale if p is not None else 0.0

    def eps_of(self, pool: str) -> List[int]:
        return self.pool_eps.get(pool) or next(iter(self.pool_eps.values()))

    # -------------------------------------------------------------- admission
    def _sample_out(self) -> int:
        mu = np.log(max(self.spec.mean_out, 1)) - self.spec.out_sigma ** 2 / 2.0
        cap = self.spec.max_out or 8 * self.spec.mean_out
        return int(np.clip(self.rng.lognormal(mu, self.spec.out_sigma), 1, cap))

    def admit(self, item: Any, now: float) -> int:
        """Start the decode phase of a request whose TTFT just materialised.

        Returns the number of D2D flows submitted (rebalancing may trigger
        immediately when admission lands on an already-hot endpoint)."""
        pool = self.pools.get(item.pool) or next(iter(self.pools.values()))
        eps = self.eps_of(pool.name)
        # the session lives where its group-0 P2D KV landed (StageEmitter
        # spreads group g to eps[(rid + g) % len]): admission imbalance is
        # real, which is exactly what the rebalancer exists to fix
        ep = eps[item.rid % len(eps)]
        out = item.out_tokens if item.out_tokens > 0 else self._sample_out()
        rel = (item.slo_scale / self.spec.standard_scale) \
            if item.slo_scale > 0 else 1.0
        sess = DecodeSession(
            rid=item.rid, pool=pool.name, ep=ep, prompt_tokens=item.n_tokens,
            out_tokens=out, tpot_budget=pool.tpot_budget * rel,
            started=now, last_token=now, payload=item.payload)
        self.stats["admitted"] += 1
        self._log("admit", sess.rid, ep, now, out)
        if self.rt is not None:
            self.rt.host.on_decode_admitted(sess)
        if out <= 1:                       # first token was the whole output
            sess.state = "done"
            sess.finished = now
            self.stats["finished"] += 1
            self._release_kv(sess.rid)
            if self.rt is not None:
                self.rt.host.on_decode_done(sess)
            return 0
        self.sessions[sess.rid] = sess
        if len(self.active[ep]) + self.incoming[ep] < pool.slots_per_ep:
            self._activate(sess, ep, now)
        else:
            # placement is sticky: the session's KV lives on ``ep``, so it
            # can only start there — escaping a hot endpoint requires a D2D
            # migration (that asymmetry is what the rebalancer exists for)
            self._enqueue(sess)
        return self._maybe_rebalance(pool.name, now)

    def _enqueue(self, sess: DecodeSession) -> None:
        sess.state = "queued"
        self.queued[sess.pool].append(sess)
        self.queued_on[sess.ep] += 1

    def _activate(self, sess: DecodeSession, ep: int, now: float) -> None:
        sess.ep = ep
        sess.state = "active"
        self.active[ep][sess.rid] = sess
        self._ensure_step(ep, now)

    # --------------------------------------------------------------- stepping
    def _step_time(self, ep: int) -> float:
        members = self.active[ep]
        ctx = float(np.mean([s.ctx_tokens for s in members.values()]))
        return self.profile.decode_step_time(len(members), ctx)

    def _ensure_step(self, ep: int, now: float) -> None:
        if self.active[ep] and not self._step_armed[ep]:
            self._step_armed[ep] = True
            # the batch is fixed when the step launches (continuous batching
            # admits at step boundaries): sessions activated while this step
            # is in flight wait for the next one
            self._step_members[ep] = tuple(self.active[ep])
            self.rt.evq.push(now + self._step_time(ep), "dstep", ep)

    def on_step(self, ep: int, now: float) -> int:
        """One batched decode step finished on ``ep``: every session that
        was in the launched batch (and is still resident) gains a token;
        finished sessions release their slot (queue drains). Returns the
        number of D2D flows submitted by rebalance checks."""
        self._step_armed[ep] = False
        batch = self._step_members.pop(ep, ())
        members = [self.active[ep][r] for r in batch if r in self.active[ep]]
        if members:
            self.stats["steps"] += 1
        for sess in members:
            gap = now - sess.last_token
            sess.gap_sum += gap
            sess.gap_max = max(sess.gap_max, gap)
            sess.last_token = now
            sess.tokens_done += 1
            sess.no_migrate = False    # progress: migration is an option again
            self.stats["tokens"] += 1
            self._log("token", sess.rid, ep, now, sess.tokens_done)
            if sess.tokens_done >= sess.out_tokens:
                self._finish(sess, now)
        self._ensure_step(ep, now)
        return self._maybe_rebalance(self._pool_of_ep[ep], now)

    def _finish(self, sess: DecodeSession, now: float) -> None:
        self.active[sess.ep].pop(sess.rid, None)
        self.sessions.pop(sess.rid, None)        # O(active): evict on finish
        sess.state = "done"
        sess.finished = now
        self.stats["finished"] += 1
        self._release_kv(sess.rid)
        self._log("finish", sess.rid, sess.ep, now, sess.tokens_done)
        if self.rt is not None:
            self.rt.host.on_decode_done(sess)
            mon = getattr(self.rt, "monitor", None)
            if mon is not None:
                mon.on_decode_finished(sess, now)
        self._drain_queue(sess.pool, sess.ep, now)

    def _drain_queue(self, pool: str, ep: int, now: float) -> None:
        """Start queued sessions whose KV lives on ``ep`` (sticky placement:
        a freed slot only helps requests already resident there)."""
        q = self.queued[pool]
        slots = self.pools[pool].slots_per_ep
        while self.queued_on[ep] \
                and len(self.active[ep]) + self.incoming[ep] < slots:
            sess = next(s for s in q if s.ep == ep)
            q.remove(sess)
            self.queued_on[ep] -= 1
            self._activate(sess, ep, now)

    # ------------------------------------------------------------- rebalancer
    def _loads(self, pool: str) -> Dict[int, int]:
        """Per-endpoint load = active + queued-resident sessions + migrations
        already headed there (counting inbound work prevents thrash)."""
        return {ep: len(self.active[ep]) + self.queued_on[ep]
                + self.incoming[ep] for ep in self.pool_eps[pool]}

    def _maybe_rebalance(self, pool: str, now: float) -> int:
        """Hysteresis-gated pool rebalancing: start migrating when the
        max-min session spread reaches ``trigger_delta``, keep going until
        it falls to ``release_delta`` (or the in-flight cap is hit)."""
        spec = self.spec
        if (not spec.rebalance or self.rt is None
                or len(self.pool_eps[pool]) < 2):
            return 0
        loads = self._loads(pool)
        delta = max(loads.values()) - min(loads.values())
        if not self._rebalancing[pool]:
            if delta < spec.trigger_delta:
                return 0
            self._rebalancing[pool] = True
        n_submitted = 0
        while self._inflight[pool] < spec.max_inflight:
            loads = self._loads(pool)
            # deterministic tie-break on endpoint id for host parity
            src = max(loads, key=lambda e: (loads[e], -e))
            dst = min(loads, key=lambda e: (loads[e], e))
            if loads[src] - loads[dst] <= spec.release_delta:
                self._rebalancing[pool] = False
                break
            victim = self._pick_victim(src)
            if victim is None:
                break
            self._start_migration(victim, src, dst, now)
            n_submitted += 1
        return n_submitted

    def _pick_victim(self, ep: int) -> Optional[DecodeSession]:
        """Queued-resident sessions first (they are stalled on the hot
        endpoint and migrating them costs no token gap), then the active
        session with the most remaining tokens (the migration amortises
        best); sessions about to finish are never moved."""
        best: Optional[DecodeSession] = None
        if self.queued_on[ep]:
            for sess in self.queued[self._pool_of_ep[ep]]:
                if sess.ep != ep or sess.no_migrate \
                        or sess.remaining < self.spec.min_migrate_remaining:
                    continue
                if best is None or (sess.remaining, -sess.rid) \
                        > (best.remaining, -best.rid):
                    best = sess
            if best is not None:
                return best
        for sess in self.active[ep].values():
            if sess.no_migrate \
                    or sess.remaining < self.spec.min_migrate_remaining:
                continue
            if best is None or (sess.remaining, -sess.rid) > (best.remaining,
                                                              -best.rid):
                best = sess
        return best

    def d2d_deadline(self, sess: DecodeSession, now: float) -> float:
        """Implicit D2D deadline from the destination's next-token budget:
        the KV must arrive by the time the request's TPOT SLO entitles it to
        its next token; a request ahead of budget donates its accrued slack
        (never less than one token budget from now)."""
        next_due = sess.started + sess.tpot_budget * sess.tokens_done
        return max(next_due, now + sess.tpot_budget)

    def _start_migration(self, sess: DecodeSession, src: int, dst: int,
                         now: float) -> None:
        if sess.state == "queued":
            self.queued[sess.pool].remove(sess)
            self.queued_on[src] -= 1
        else:
            self.active[src].pop(sess.rid, None)
        sess.state = "migrating"
        sess.migrate_dst = dst
        sess.n_migrations += 1
        self.incoming[dst] += 1
        self._inflight[sess.pool] += 1
        size = sess.ctx_tokens * self._kv_per_tok + self._state_b
        f = Flow(new_flow_id(), sess.rid, -1, Stage.D2D, size,
                 src=src, dst=dst, target_layer=0, n_layers=self._G,
                 deadline=self.d2d_deadline(sess, now))
        sess.d2d_fid = f.fid
        self.stats["migrations"] += 1
        self.stats["d2d_bytes"] += size
        self._log("d2d", sess.rid, dst, now, src)
        self.rt._submit(f)
        self._drain_queue(sess.pool, src, now)   # the freed slot is real

    def on_d2d_done(self, flow: Flow, now: float) -> int:
        """Migration landed: the session resumes on the destination (the
        token gap spanning the migration is a real TBT hit)."""
        sess = self.sessions.get(flow.rid)
        if sess is None or sess.state != "migrating" \
                or sess.d2d_fid != flow.fid:
            return 0                     # stale (e.g. session evicted)
        dst = sess.migrate_dst
        sess.migrate_dst = -1
        sess.d2d_fid = -1
        self.incoming[dst] -= 1
        self._inflight[sess.pool] -= 1
        self._log("migrated", sess.rid, dst, now, sess.tokens_done)
        sess.ep = dst
        slots = self.pools[sess.pool].slots_per_ep
        if len(self.active[dst]) + self.incoming[dst] < slots:
            self._activate(sess, dst, now)
        else:                       # dst filled up while the KV was in flight
            self._enqueue(sess)
        return self._maybe_rebalance(sess.pool, now)

    # ----------------------------------------------- decode-side auto-eviction
    def auto_evict_enabled(self) -> bool:
        return self.spec.auto_evict and self.spec.rebalance

    def _spill_target(self, sess: DecodeSession) -> Optional[str]:
        """Bulk pool loose sessions spill into: the configured
        ``spill_pool``, or the loosest-TPOT-budget pool besides the
        session's own."""
        if self.spec.spill_pool and self.spec.spill_pool in self.pools \
                and self.spec.spill_pool != sess.pool:
            return self.spec.spill_pool
        others = [p for p in self.pools.values() if p.name != sess.pool]
        if not others:
            return None
        return max(others, key=lambda p: p.tpot_budget).name

    def _readmit(self, sess: DecodeSession, pool: str, ep: int,
                 now: float) -> None:
        """Put an auto-evicted session back onto the plane (same or spill
        pool); placement is sticky again from ``ep``."""
        sess.ep = ep
        sess.pool = pool
        sess.migrate_dst = -1
        sess.d2d_fid = -1
        sess.no_migrate = True
        self.sessions[sess.rid] = sess
        slots = self.pools[pool].slots_per_ep
        if len(self.active[ep]) + self.incoming[ep] < slots:
            self._activate(sess, ep, now)
        else:
            self._enqueue(sess)

    def auto_evict(self, now: float) -> int:
        """The TPOT-budget eviction rule closing the Algorithm-1 decode
        loop: any in-flight migration whose derived deadline has become
        *infeasible* — the remaining KV cannot arrive by the deadline even
        at the bottleneck link's full capacity — is abandoned via
        :meth:`evict` (cancels the D2D, releases the reserved slots). The
        session is then re-admitted per class: loose sessions spill to the
        bulk pool (looser budget, fresh sticky placement), other sessions
        re-queue on their source endpoint, and loose sessions with nowhere
        to spill are dropped for good — their KV blocks are released back
        through the KV store. Called from the runtime's periodic tick;
        returns the number of sessions acted on (callers resched if > 0).
        """
        if self.rt is None:
            return 0
        acted = 0
        net = self.rt.net
        for sess in [s for s in self.sessions.values()
                     if s.state == "migrating"]:
            fl = self.rt.flows.get(sess.d2d_fid)
            if fl is None or fl.deadline is None:
                continue
            # exclusive-service ceiling = the route's MINIMUM capacity (the
            # most-utilised link can be a fat spine; the NIC still caps
            # actual delivery)
            route = net.routes.get(fl.fid)
            if route is None:
                route = net.topo.route(fl.src, fl.dst, fl.fid)
            cap = min((net.topo.capacity[l] for l in route), default=2e12)
            t_rem = fl.deadline - now
            if t_rem > 0 and fl.remaining <= cap * t_rem:
                continue                       # still feasible: keep going
            src = sess.ep                      # KV never left the source
            cls = getattr(sess.payload, "slo_class", None)
            self.evict(sess.rid, now)          # abandon D2D + release slots
            self.stats["evicted"] -= 1         # re-bucketed below
            self.stats["abandoned"] += 1
            self._log("abandon", sess.rid, src, now, sess.tokens_done)
            spill = self._spill_target(sess)
            if cls == "loose" and spill is not None:
                rel = (sess.tpot_budget
                       / max(self.pools[sess.pool].tpot_budget, 1e-12))
                sess.tpot_budget = self.pools[spill].tpot_budget * rel
                loads = self._loads(spill)
                dst = min(loads, key=lambda e: (loads[e], e))
                self._readmit(sess, spill, dst, now)
                self.stats["spilled"] += 1
                self._log("spill", sess.rid, dst, now, src)
            elif cls != "loose":
                self._readmit(sess, sess.pool, src, now)
            else:                              # loose, nowhere to spill:
                self.stats["evicted"] += 1     # dropped for good (evict()
                self.stats["dropped"] += 1     # already released its KV pins)
            acted += 1
        return acted

    # --------------------------------------------------------------- eviction
    def evict(self, rid: int, now: float) -> bool:
        """Hard-evict a decode session (decode-side overload control / host
        cancellation): releases its pool slot, cancels any in-flight D2D
        flow, and drops all plane state — the O(active) invariant holds."""
        sess = self.sessions.pop(rid, None)
        if sess is None:
            return False
        if sess.state == "active":
            self.active[sess.ep].pop(rid, None)
        elif sess.state == "migrating":
            self.incoming[sess.migrate_dst] -= 1
            self._inflight[sess.pool] -= 1
            rt = self.rt
            fl = rt.flows.get(sess.d2d_fid) if rt is not None else None
            if fl is not None:
                if fl.fid in rt.net.flows:
                    rt.net.remove(fl)
                rt.policy.on_flow_completed(fl, rt.view)
                rt._evict_flow(fl)
        elif sess.state == "queued":
            try:
                self.queued[sess.pool].remove(sess)
                self.queued_on[sess.ep] -= 1
            except ValueError:
                pass
        sess.state = "evicted"
        self.stats["evicted"] += 1
        self._release_kv(rid)   # the session's KV blocks return to the store
        self._log("evict", rid, sess.ep, now, sess.tokens_done)
        self._drain_queue(sess.pool, sess.ep, now)
        return True

    # ---------------------------------------------------------------- queries
    def n_active(self) -> int:
        return sum(len(m) for m in self.active.values())

    def summary(self) -> Dict[str, float]:
        s = dict(self.stats)
        s["live_sessions"] = len(self.sessions)
        return s
