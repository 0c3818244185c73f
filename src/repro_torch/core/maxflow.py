"""Offline max-flow optimality yardstick (Helix-style attainment ceiling).

Every BENCH number so far is a *ratio over weak baselines*; this module
turns attainment into an **absolute** measurement by computing what the
cluster could do at all — a per-(workload, rate) ceiling no scheduler can
exceed — so each policy's attainment is additionally reported as a fraction
of that ceiling (``benchmarks/largescale.py`` ``yardstick`` arm).

The bound follows Helix's ``global_maxflow_scheduler`` idea: model the
serving pipeline as a single-commodity flow network in **requests/second**
— source → per-unit compute capacity → per-unit NIC egress (link bytes/s ÷
expected bytes/request) → fabric → aggregate decode ingress → sink — and
take the max-flow. A min-cut may mix compute and network edges, which is
exactly what makes the bound tighter than min(compute, network) computed
separately per resource class. Two network readings are reported:

  * **fixed-route** (:func:`fixed_route_rate`): expected per-request bytes
    on each *concrete directed link* under the actual emission + routing
    rules (replayed by the caller), ceiling = min over links of
    capacity/bytes. This is the ceiling *given* the deployed placement.
  * **routing-free** (:func:`disagg_bound` over :class:`FlowGraph`): the
    Dinic bound with placement freedom — an upper bound on any router.

The **attainment ceiling** at arrival rate ``λ`` combines the throughput
bound ``R*`` with per-request feasibility: a request whose contention-free
ideal TTFT already exceeds its deadline budget is unservable by *any*
schedule, so ``ceiling(λ) = feasible_frac × min(1, R*/λ)``.

Deterministic throughout (plain BFS/DFS Dinic, no RNG), control-plane only
(no JAX). The bound is optimistic by construction — deferrable stages (WB)
and perfectly-affine reuse fetches (S1) are excluded from demand — so every
measured attainment must land at or below it.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Dinic", "FlowGraph", "fixed_route_rate", "disagg_bound",
           "attainment_ceiling"]

_INF = float("inf")
_EPS = 1e-12


class Dinic:
    """Deterministic Dinic max-flow on float capacities.

    Standard level-graph BFS + blocking-flow DFS; edges are visited in
    insertion order, so the flow value (and the full residual state) is a
    pure function of the construction sequence."""

    def __init__(self, n: int = 0):
        self.n = n
        # edge i: (to, cap); edge i^1 is its reverse
        self._to: List[int] = []
        self._cap: List[float] = []
        self._adj: List[List[int]] = [[] for _ in range(n)]

    def add_node(self) -> int:
        self._adj.append([])
        self.n += 1
        return self.n - 1

    def add_edge(self, u: int, v: int, cap: float) -> int:
        if cap < 0:
            raise ValueError(f"negative capacity {cap} on edge {u}->{v}")
        eid = len(self._to)
        self._to.extend((v, u))
        self._cap.extend((cap, 0.0))
        self._adj[u].append(eid)
        self._adj[v].append(eid + 1)
        return eid

    def _levels(self, s: int, t: int) -> Optional[List[int]]:
        level = [-1] * self.n
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for eid in self._adj[u]:
                v = self._to[eid]
                if level[v] < 0 and self._cap[eid] > _EPS:
                    level[v] = level[u] + 1
                    q.append(v)
        return level if level[t] >= 0 else None

    def _push(self, u: int, t: int, f: float, level: List[int],
              it: List[int]) -> float:
        if u == t:
            return f
        while it[u] < len(self._adj[u]):
            eid = self._adj[u][it[u]]
            v = self._to[eid]
            if self._cap[eid] > _EPS and level[v] == level[u] + 1:
                d = self._push(v, t, min(f, self._cap[eid]), level, it)
                if d > _EPS:
                    self._cap[eid] -= d
                    self._cap[eid ^ 1] += d
                    return d
            it[u] += 1
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        if s == t:
            return _INF
        total = 0.0
        while True:
            level = self._levels(s, t)
            if level is None:
                return total
            it = [0] * self.n
            while True:
                f = self._push(s, t, _INF, level, it)
                if f <= _EPS:
                    break
                if f == _INF:
                    return _INF        # an unbounded s->t path exists
                total += f


class FlowGraph:
    """Named-node convenience wrapper over :class:`Dinic`.

    Node ids are assigned in first-mention order, so graphs built by the
    same construction sequence are identical — determinism for free."""

    def __init__(self) -> None:
        self._dinic = Dinic()
        self._ids: Dict[str, int] = {}

    def node(self, name: str) -> int:
        nid = self._ids.get(name)
        if nid is None:
            nid = self._ids[name] = self._dinic.add_node()
        return nid

    def edge(self, a: str, b: str, cap: float) -> None:
        self._dinic.add_edge(self.node(a), self.node(b), cap)

    def max_flow(self, s: str = "S", t: str = "T") -> float:
        return self._dinic.max_flow(self.node(s), self.node(t))


def fixed_route_rate(link_bytes: Mapping[int, float],
                     capacity: Sequence[float],
                     ) -> Tuple[float, Optional[int]]:
    """Fixed-route throughput ceiling: ``min over links of capacity[l] /
    bytes-per-request[l]`` (requests/second), plus the arg-min link.

    ``link_bytes`` maps directed link id → *expected bytes one request puts
    on that link* under the deployed emission/routing rules (the caller
    replays the emitter to measure this). Links a request never touches are
    simply absent. Returns ``(inf, None)`` when there is no demand."""
    best, best_lid = _INF, None
    for lid, b in link_bytes.items():
        if b <= 0.0:
            continue
        r = capacity[lid] / b
        if r < best:
            best, best_lid = r, lid
    return best, best_lid


def disagg_bound(unit_rates: Sequence[float],
                 unit_out_caps: Sequence[float],
                 out_bytes: float,
                 decode_in_caps: Sequence[float],
                 in_bytes: float) -> float:
    """Routing-free max-flow bound for the disaggregated prefill→decode
    pipeline, in requests/second.

    ``S → unit_u (compute) → NIC_u (egress) → fabric → decode ingress
    (aggregate) → T``: ``unit_rates[u]`` is unit ``u``'s compute throughput
    (req/s), ``unit_out_caps[u]`` its total NIC egress (bytes/s),
    ``out_bytes``/``in_bytes`` the mean per-request bytes leaving a prefill
    unit / entering the decode tier. Decode ingress is aggregated (one
    edge: Σ caps ÷ bytes) — placement freedom on both sides, so the value
    upper-bounds any concrete router."""
    g = FlowGraph()
    for u, r in enumerate(unit_rates):
        g.edge("S", f"u{u}", r)
        g.edge(f"u{u}", f"n{u}",
               unit_out_caps[u] / out_bytes if out_bytes > 0.0 else _INF)
        g.edge(f"n{u}", "X", _INF)
    agg = sum(decode_in_caps)
    g.edge("X", "D", agg / in_bytes if in_bytes > 0.0 else _INF)
    g.edge("D", "T", _INF)
    return g.max_flow("S", "T")


def attainment_ceiling(rate: float, r_star: float,
                       feasible_frac: float = 1.0) -> float:
    """SLO-attainment ceiling at arrival rate ``rate`` given throughput
    bound ``r_star`` and the fraction of requests whose contention-free
    ideal TTFT fits inside their deadline budget. No scheduler can serve
    more than ``min(1, R*/λ)`` of the offered load, and of the served
    share at most ``feasible_frac`` can make its deadline."""
    if rate <= 0.0:
        return feasible_frac
    return feasible_frac * min(1.0, r_star / rate)
