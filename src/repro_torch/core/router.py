"""Router + admission-control plane — pluggable cluster-level placement.

The paper schedules flows *after* a request has been routed, but placement
decides which bottleneck links those flows ever contend on ("Taming Request
Imbalance": SLO attainment in disaggregated serving hinges on
imbalance-aware placement). Until this module existed the router was one
hard-coded rule — ``kv_route``'s 2:1 hit-weighted affinity vs. backlog —
with a near-duplicate fallback copy in each host. This module makes
placement a policy surface, mirroring how ``policies.py`` registers
schedulers and following vLLM production-stack's router layout
(interchangeable affinity policies behind a factory, queue-depth overload
detectors):

  * :class:`RouterPolicy` + a registry (:func:`register_router` /
    :func:`make_router`) with four strategies —

      - ``kv_affinity``   — the historical rule, extracted so both hosts
        share one code path: score every unit by ``2.0 * affinity -
        backlog_tokens`` where affinity is the locally-resident reusable
        prefix (live KV-store residency when a store is attached, the
        trace/prefix-index owner oracle otherwise). Bit-identical to the
        old per-host loops by construction.
      - ``round_robin``   — arrival-order cycling, placement-blind.
      - ``session_affinity`` — rendezvous (highest-random-weight) hashing
        of a stable session key (``rid`` by default, the request's prefix
        identity with ``key="prefix"``), modelled on production-stack's
        ``session_affinity``/``simhash_affinity``: the same session always
        lands on the same unit, with minimal movement as units change.
      - ``least_backlog`` — pure join-the-shortest-queue on backlog tokens.

  * :class:`OverloadDetector` + a registry (:func:`make_detector`) with two
    hysteresis-gated variants — ``queue_depth`` (queued requests or backlog
    tokens vs. high/low watermarks, cluster- or unit-scoped, after
    production-stack's ``num_queueing_request``) and ``laxity_debt`` (the
    summed deadline debt of queued work: how many seconds of already-missed
    slack the queues carry).

  * :class:`AdmissionController` — an admission stage between routing and
    enqueue (Ascendra's pairing of dynamic prioritization with admission
    decisions): while the detector is tripped, requests of the sheddable
    SLO classes (loose, by default) are **shed** (rejected: no pins, no
    slots, counted as an SLO miss against all-arrivals attainment) or
    **deferred** (re-tried after a delay on the original arrival clock, so
    the SLO budget keeps burning) — protecting the TTFT attainment of the
    admitted traffic instead of letting everyone miss.

The plane is host-agnostic like the rest of ``repro.core``: the shared
:class:`repro.core.runtime.MsFlowRuntime` calls the policy through a
:class:`RoutingView` (backlogs, queues, KV-store residency, clock); hosts
only supply state (``prepare_route`` fills the item's legacy reuse/owner
fields, ``kv_chain_keys`` exposes the store keys). The default
configuration — ``kv_affinity`` with admission off — reproduces the
pre-plane placement decisions bit-for-bit on both hosts.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Type

__all__ = [
    "RoutingView",
    "RouterPolicy",
    "KVAffinityRouter",
    "RoundRobinRouter",
    "SessionAffinityRouter",
    "LeastBacklogRouter",
    "register_router",
    "make_router",
    "OverloadDetector",
    "QueueDepthDetector",
    "LaxityDebtDetector",
    "register_detector",
    "make_detector",
    "RouterSpec",
    "AdmissionSpec",
    "AdmissionController",
]


class RoutingView:
    """What a router policy / overload detector may observe.

    A thin read-only window over the shared runtime: placement state
    (per-unit backlogs and queues), the KV-reuse plane when one is
    attached, and the virtual clock. Hosts are reached only through the
    ``kv_chain_keys`` hook — the view never touches host internals.
    """

    def __init__(self, rt: Any):
        self.rt = rt

    @property
    def now(self) -> float:
        return self.rt.net.now

    @property
    def n_units(self) -> int:
        return self.rt.n_units

    @property
    def backlogs(self):
        """Per-unit queued+active prefill tokens (the load signal the
        historical router scored against)."""
        return self.rt.backlog_tokens

    @property
    def kvstore(self):
        """The attached KV-reuse plane, or None (legacy reuse model)."""
        return self.rt.kvstore

    def chain_keys(self, item: Any) -> Tuple:
        """The request's block-key chain (same keys Stage-1 resolves)."""
        return self.rt.host.kv_chain_keys(item)

    def queued(self, unit: int) -> int:
        """Requests waiting in ``unit``'s prefill queue."""
        return len(self.rt.queues[unit])

    def queued_items(self, unit: int) -> Iterable[Any]:
        return iter(self.rt.queues[unit])

    def total_queued(self) -> int:
        return sum(len(q) for q in self.rt.queues)

    def session_key(self, item: Any) -> Tuple:
        """A stable per-session identity for consistent hashing: the
        request's prefix lineage when the host exposes one (trace
        ``prefix_id``), else its rid. Both hosts derive the same key for
        the same rid, so rid-keyed placement is host-parity-exact."""
        pid = getattr(item.payload, "prefix_id", None)
        if pid is not None:
            return ("prefix", int(pid))
        return ("rid", int(item.rid))


# ------------------------------------------------------------ router policies
class RouterPolicy:
    """Cluster-level placement policy: pick the prefill unit for an
    arriving request. Implementations must be deterministic functions of
    (item, view, own state) so both hosts place identically and fixed
    seeds reproduce — no wall clock, no unseeded RNG."""

    name = "base"

    def place(self, item: Any, view: RoutingView) -> int:
        raise NotImplementedError

    def attach_bus(self, bus: Any) -> None:
        """Monitor-plane hook: called once when a ``SignalBus`` is live
        (``ClusterSpec.monitor`` / ``DisaggConfig.monitor`` set). Policies
        that score on streaming signals (rolling link contention, TTFT
        quantiles, laxity debt — ``bus.read(name, key)``) override this;
        the base class ignores it so existing routers are bus-agnostic."""

    def reset(self) -> None:
        """Clear cross-run state (routers are rebuilt per host, but the
        registry contract mirrors ``Policy.reset`` for reuse)."""


def kv_affinity_score(aff: float, backlog: float,
                      affinity_weight: float = 2.0) -> float:
    """The historical routing score both hosts hard-coded: hit-weighted
    affinity (reusable tokens resident on the unit) against its token
    backlog. One definition so the duplicated loops cannot drift."""
    return affinity_weight * aff - backlog


class KVAffinityRouter(RouterPolicy):
    """The extracted historical rule (default router).

    With a KV store attached, affinity is the live per-unit resident-token
    count along the chain's leading hit run (:meth:`KVStore.peek_affinity`
    — read-only; the winner's block plan is resolved by the runtime after
    placement, exactly the old ``kv_route`` order). Without a store,
    affinity falls back to the item's pre-resolved ``(reuse, owner_unit)``
    oracle — the trace's static owner on the simulator, the prefix-index
    entry's owner on the serving path. ``owner_unit < 0`` means "no owner"
    (serving-path miss): no unit gets affinity credit.
    """

    name = "kv_affinity"

    def __init__(self, affinity_weight: float = 2.0):
        self.affinity_weight = affinity_weight

    def place(self, item: Any, view: RoutingView) -> int:
        n = view.n_units
        store = view.kvstore
        if store is not None:
            aff = store.peek_affinity(view.chain_keys(item),
                                      max(0, item.n_tokens - 1), n)
        else:
            owner = item.owner_unit
            aff = [item.reuse if u == owner else 0 for u in range(n)]
        backlogs = view.backlogs
        best, best_score = 0, -float("inf")
        for u in range(n):
            score = kv_affinity_score(aff[u], backlogs[u],
                                      self.affinity_weight)
            if score > best_score:
                best, best_score = u, score
        return best


class RoundRobinRouter(RouterPolicy):
    """Arrival-order cycling over the units. Placement-blind by design —
    the classic load-oblivious baseline (production-stack's
    ``round_robin_affinity``)."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def place(self, item: Any, view: RoutingView) -> int:
        u = self._next % view.n_units
        self._next += 1
        return u

    def reset(self) -> None:
        self._next = 0


def _rendezvous_hash(key: Tuple, unit: int, salt: str) -> int:
    """Deterministic 64-bit weight for (session key, unit) — independent of
    PYTHONHASHSEED and identical across hosts/processes."""
    h = hashlib.blake2b(repr((salt, key, unit)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class SessionAffinityRouter(RouterPolicy):
    """Consistent session → unit hashing (rendezvous / highest-random-
    weight): every unit gets a deterministic pseudo-random weight for the
    session key and the max wins, so a session always lands on the same
    unit and re-sizing the cluster moves only ~1/n of sessions. ``key``
    selects the session identity: ``"rid"`` (host-parity-exact) or
    ``"prefix"`` (requests sharing a prefix lineage co-locate — cache
    affinity without a live store)."""

    name = "session_affinity"

    def __init__(self, key: str = "rid", salt: str = "mfs-router"):
        if key not in ("rid", "prefix"):
            raise ValueError(f"session key must be 'rid' or 'prefix', "
                             f"got {key!r}")
        self.key = key
        self.salt = salt

    def _session_key(self, item: Any, view: RoutingView) -> Tuple:
        if self.key == "prefix":
            return view.session_key(item)
        return ("rid", int(item.rid))

    def place(self, item: Any, view: RoutingView) -> int:
        skey = self._session_key(item, view)
        return max(range(view.n_units),
                   key=lambda u: _rendezvous_hash(skey, u, self.salt))


class LeastBacklogRouter(RouterPolicy):
    """Join-the-shortest-queue on backlog tokens (deterministic lowest-id
    tie-break) — pure load balancing, affinity-blind."""

    name = "least_backlog"

    def place(self, item: Any, view: RoutingView) -> int:
        backlogs = view.backlogs
        best, best_b = 0, float("inf")
        for u in range(view.n_units):
            if backlogs[u] < best_b:
                best, best_b = u, backlogs[u]
        return best


_ROUTERS: Dict[str, Type[RouterPolicy]] = {}


def register_router(cls: Type[RouterPolicy]) -> Type[RouterPolicy]:
    """Register a RouterPolicy subclass under its ``name`` (decorator)."""
    _ROUTERS[cls.name] = cls
    return cls


for _cls in (KVAffinityRouter, RoundRobinRouter, SessionAffinityRouter,
             LeastBacklogRouter):
    register_router(_cls)


def make_router(name: str, **kw) -> RouterPolicy:
    if name not in _ROUTERS:
        raise KeyError(f"unknown router policy {name!r}; "
                       f"choose from {sorted(_ROUTERS)}")
    return _ROUTERS[name](**kw)


# -------------------------------------------------------- overload detectors
class OverloadDetector:
    """Hysteresis-gated overload signal driving the admission stage.

    ``update(view, unit)`` is called once per arriving request with the
    routed unit; it refreshes the internal tripped state and returns it.
    Implementations trip when their signal crosses ``high`` and recover
    only once it falls back to ``low`` (two watermarks, so a burst cannot
    flap admission on and off every request).

    With the monitor plane attached the runtime calls :meth:`attach_bus`,
    and detectors read their signal from the ``SignalBus`` instead of
    computing it in-detector. The bus providers are the *same expressions*
    registered as live-view closures (``Monitor.bind_live``), so trip and
    recovery happen at byte-identical times either way (regression-tested
    in ``tests/test_monitor.py``) — the migration buys a shared namespace
    (new detectors subscribe to any signal by name), not new numbers.
    """

    name = "base"
    #: bus signal this detector reads when attached (None = in-detector
    #: computation only; subclasses set or compute it)
    bus_signal: Optional[str] = None

    def __init__(self, high: float, low: float):
        if low > high:
            raise ValueError(f"hysteresis needs low <= high, "
                             f"got low={low} high={high}")
        self.high = high
        self.low = low
        self.tripped = False
        self.n_trips = 0
        self.bus: Any = None

    def attach_bus(self, bus: Any) -> None:
        """Subscribe to the monitor's SignalBus: subsequent ``signal()``
        calls read ``bus_signal`` from the bus when it carries it."""
        if self.bus_signal is not None and bus.has(self.bus_signal):
            self.bus = bus

    def signal(self, view: RoutingView, unit: int) -> float:
        raise NotImplementedError

    def update(self, view: RoutingView, unit: int) -> bool:
        v = self.signal(view, unit)
        if not self.tripped:
            if v >= self.high:
                self.tripped = True
                self.n_trips += 1
        elif v <= self.low:
            self.tripped = False
        return self.tripped

    def reset(self) -> None:
        self.tripped = False
        self.n_trips = 0


class QueueDepthDetector(OverloadDetector):
    """Queue-depth overload (production-stack's ``num_queueing_request``):
    the signal is queued prefill requests (``signal="requests"``) or
    backlog tokens (``signal="tokens"``), summed cluster-wide
    (``scope="cluster"``) or read at the routed unit (``scope="unit"``)."""

    name = "queue_depth"

    def __init__(self, high: float = 64, low: float = 16,
                 signal: str = "requests", scope: str = "cluster"):
        super().__init__(high, low)
        if signal not in ("requests", "tokens"):
            raise ValueError(f"signal must be 'requests' or 'tokens', "
                             f"got {signal!r}")
        if scope not in ("cluster", "unit"):
            raise ValueError(f"scope must be 'cluster' or 'unit', "
                             f"got {scope!r}")
        self._signal = signal
        self.scope = scope
        self.bus_signal = f"queue.{signal}.{scope}"

    def signal(self, view: RoutingView, unit: int) -> float:
        if self.bus is not None:
            # bus-backed: the provider is the same expression as below,
            # registered by Monitor.bind_live — byte-identical trip points
            return self.bus.read(self.bus_signal,
                                 unit if self.scope == "unit" else None)
        if self._signal == "requests":
            if self.scope == "unit":
                return float(view.queued(unit))
            return float(view.total_queued())
        if self.scope == "unit":
            return float(view.backlogs[unit])
        return float(sum(view.backlogs))


class LaxityDebtDetector(OverloadDetector):
    """Deadline-debt overload: for every queued request, debt is the slack
    it has *already* lost — ``max(0, (now + ideal_ttft) - deadline)``
    seconds (even served immediately and contention-free it misses by that
    much). The summed debt is the signal: queue depth measures how much
    work waits, laxity debt measures how late that work already is —
    Ascendra's distinction between load and urgency. Watermarks are in
    seconds of aggregate debt."""

    name = "laxity_debt"
    bus_signal = "laxity.debt"

    def __init__(self, high: float = 2.0, low: float = 0.5):
        super().__init__(high, low)

    def signal(self, view: RoutingView, unit: int) -> float:
        if self.bus is not None:
            # bus-backed: Monitor.bind_live registers this exact summation
            return self.bus.read(self.bus_signal)
        now = view.now
        debt = 0.0
        for u in range(view.n_units):
            for it in view.queued_items(u):
                debt += max(0.0, (now + it.ideal_ttft) - it.deadline)
        return debt


_DETECTORS: Dict[str, Type[OverloadDetector]] = {}


def register_detector(cls: Type[OverloadDetector]) -> Type[OverloadDetector]:
    _DETECTORS[cls.name] = cls
    return cls


for _cls in (QueueDepthDetector, LaxityDebtDetector):
    register_detector(_cls)


def make_detector(name: str, **kw) -> OverloadDetector:
    if name not in _DETECTORS:
        raise KeyError(f"unknown overload detector {name!r}; "
                       f"choose from {sorted(_DETECTORS)}")
    return _DETECTORS[name](**kw)


# ------------------------------------------------------------- configuration
@dataclass(frozen=True)
class AdmissionSpec:
    """Admission-control stage configuration (``RouterSpec.admission``).

    ``mode="shed"`` rejects sheddable requests outright while the detector
    is tripped; ``mode="defer"`` re-tries them after ``defer_delay``
    seconds (on the original arrival clock — the SLO budget keeps burning)
    up to ``max_defers`` times, then sheds if the overload persists.
    ``shed_classes`` names the SLO classes admission may touch — tight and
    standard traffic is never shed by default."""

    detector: str = "queue_depth"
    detector_kw: Mapping[str, Any] = field(default_factory=dict)
    mode: str = "shed"                        # shed | defer
    shed_classes: Tuple[str, ...] = ("loose",)
    defer_delay: float = 0.25
    max_defers: int = 4

    def __post_init__(self):
        if self.mode not in ("shed", "defer"):
            raise ValueError(f"admission mode must be 'shed' or 'defer', "
                             f"got {self.mode!r}")


@dataclass(frozen=True)
class RouterSpec:
    """Routing + admission plane configuration threaded through
    ``ClusterSpec.router`` / ``DisaggConfig.router``. The default —
    ``kv_affinity`` with admission off — reproduces the historical
    placement bit-for-bit."""

    policy: str = "kv_affinity"
    params: Mapping[str, Any] = field(default_factory=dict)
    admission: Optional[AdmissionSpec] = None

    def build(self) -> RouterPolicy:
        return make_router(self.policy, **dict(self.params))

    def build_admission(self) -> Optional["AdmissionController"]:
        return AdmissionController(self.admission) \
            if self.admission is not None else None


class AdmissionController:
    """The admission stage the runtime runs between routing and enqueue."""

    def __init__(self, spec: AdmissionSpec):
        self.spec = spec
        self.detector = make_detector(spec.detector, **dict(spec.detector_kw))
        self.n_shed = 0
        self.n_deferred = 0

    def reset(self) -> None:
        self.detector.reset()
        self.n_shed = 0
        self.n_deferred = 0

    def decide(self, item: Any, view: RoutingView, unit: int) -> str:
        """``"admit"`` | ``"shed"`` | ``"defer"`` for a routed request.

        The detector state refreshes on *every* arrival (so recovery is
        observed even while only non-sheddable traffic flows); only
        requests of the sheddable classes are ever rejected or delayed."""
        tripped = self.detector.update(view, unit)
        if not tripped or item.slo_class not in self.spec.shed_classes:
            return "admit"
        if self.spec.mode == "defer" and item.deferrals < self.spec.max_defers:
            self.n_deferred += 1
            return "defer"
        self.n_shed += 1
        return "shed"
