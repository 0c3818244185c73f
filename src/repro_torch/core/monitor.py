"""Online monitor plane — streaming signals over the telemetry probe sites.

PR 8's :mod:`repro.core.telemetry` records everything and answers questions
*after* the run; this module is the **online** half of the observability
stack: a strictly passive :class:`Monitor` that computes event-clock
streaming estimators at the same probe sites and exposes them as **named
signals** on a :class:`SignalBus` that live consumers — ``OverloadDetector``
admission signals, ``RouterPolicy`` placement scores, the benchmark's
``--progress`` reporter — can read *while the run is in flight*.

Pieces:

  * :class:`MonitorSpec` — the knob carried by ``ClusterSpec.monitor`` /
    ``DisaggConfig.monitor``; ``None`` (the default everywhere) keeps the
    runtime byte-identical to the monitor-less code path.
  * :class:`Monitor` — implements the same probe-method subset the runtime
    already calls on :class:`~repro.core.telemetry.Telemetry` (arrival /
    admit / shed / defer / request-done / flow-submitted / flow-closed /
    ``on_advance``), so **no new probe sites exist**: with both planes
    attached a :class:`ProbeFanout` forwards each probe call to both
    collectors behind the runtime's single ``is not None`` guard.
  * :class:`SignalBus` — the name → provider registry. Two provider kinds
    coexist: *streaming estimators* updated by the probes (rolling link
    utilization / contended share, per-stage slack-loss rates, per-SLO-class
    TTFT/TPOT quantile sketches, rolling admitted attainment) and *live
    views* registered by the runtime as closures over its
    :class:`~repro.core.router.RoutingView` (queue depths, laxity debt) —
    the latter are byte-identical to the legacy in-detector computations,
    so migrating ``queue_depth`` / ``laxity_debt`` onto the bus moves their
    trip points by exactly nothing (regression-tested).
  * :class:`FixedBinSketch` — deterministic log-spaced fixed-bin quantile
    sketch: no RNG, no platform-dependent math at observe time (bin edges
    are precomputed once; observation is a ``bisect``), insertion-order
    independent — quantiles are host-parity-exact.
  * :class:`RollingWindow` — event-clock trailing-window accumulator
    (bucket index = ``floor(t / bucket_dt)``; no wall clock anywhere).

Everything here only *reads* runtime state (clock, net rates, item fields);
enabling the monitor never changes scheduling outcomes — monitor-on vs
monitor-off runs are bit-identical (tested, mirroring the telemetry plane's
zero-overhead guard).

Control-plane only (no JAX), host-agnostic like the rest of ``repro.core``.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .msflow import Flow

__all__ = ["MonitorSpec", "Monitor", "SignalBus", "FixedBinSketch",
           "RollingWindow", "ProbeFanout"]


# --------------------------------------------------------------------- spec
@dataclass(frozen=True)
class MonitorSpec:
    """Monitor-plane configuration (attach via ``ClusterSpec.monitor`` or
    ``DisaggConfig.monitor``; ``None`` disables the plane entirely)."""

    enabled: bool = True
    #: trailing-window length (seconds of event time) for rolling signals
    window: float = 2.0
    #: buckets per window — expiry granularity is ``window / buckets``
    buckets: int = 16
    #: link-utilization sampling pitch (same default as the telemetry plane)
    link_dt: float = 2e-3
    #: a link sample counts as contended at >= this utilization
    contended_util: float = 0.9
    #: quantile-sketch bin range [lo, hi) seconds and bin count; values are
    #: clamped into the range (TTFT/TPOT both live comfortably inside it)
    sketch_lo: float = 1e-4
    sketch_hi: float = 1e3
    sketch_bins: int = 256
    #: call ``Monitor.on_sample(monitor)`` every N finished requests
    #: (0 = never) — the benchmark's ``--progress`` hook
    sample_every: int = 0


# ---------------------------------------------------------------- estimators
class FixedBinSketch:
    """Deterministic fixed-bin quantile sketch over log-spaced bins.

    Bin edges are precomputed once from ``(lo, hi, bins)``; observing a
    value is a single ``bisect`` into those edges, so identically
    configured sketches fed the same multiset of values — in any order, on
    any host — report identical quantiles. No RNG, no merging error."""

    __slots__ = ("lo", "hi", "edges", "counts", "n")

    def __init__(self, lo: float = 1e-4, hi: float = 1e3, bins: int = 256):
        if not (lo > 0.0 and hi > lo and bins >= 2):
            raise ValueError(f"need 0 < lo < hi and bins >= 2, "
                             f"got lo={lo} hi={hi} bins={bins}")
        ratio = (hi / lo) ** (1.0 / bins)
        edges: List[float] = []
        e = lo
        for _ in range(bins - 1):
            e *= ratio
            edges.append(e)
        self.lo, self.hi = lo, hi
        self.edges = edges            # bin i covers (edges[i-1], edges[i]]
        self.counts = [0] * bins
        self.n = 0

    def observe(self, x: float) -> None:
        self.counts[bisect_left(self.edges, x)] += 1
        self.n += 1

    def quantile(self, q: float) -> float:
        """The upper edge of the bin holding the ``q``-quantile observation
        (conservative: the true value is <= the reported one), ``nan`` when
        empty."""
        if self.n == 0:
            return float("nan")
        rank = min(self.n - 1, max(0, int(q * self.n)))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc > rank:
                return self.edges[i] if i < len(self.edges) else self.hi
        return self.hi                                  # pragma: no cover


class RollingWindow:
    """Event-clock trailing-window sum: ``add(t, v)`` accumulates into the
    bucket ``floor(t / bucket_dt)``; ``sum(t)`` drops buckets older than
    ``window`` first. Purely event-time — no wall clock, no RNG."""

    __slots__ = ("window", "bucket_dt", "_buckets", "_total")

    def __init__(self, window: float = 2.0, buckets: int = 16):
        self.window = window
        self.bucket_dt = window / max(1, buckets)
        self._buckets: deque = deque()       # [bucket_index, sum] pairs
        self._total = 0.0

    def _expire(self, t: float) -> None:
        cut = t - self.window
        bd = self.bucket_dt
        while self._buckets and (self._buckets[0][0] + 1) * bd <= cut:
            self._total -= self._buckets.popleft()[1]

    def add(self, t: float, v: float) -> None:
        self._expire(t)
        idx = int(t / self.bucket_dt)
        if self._buckets and self._buckets[-1][0] == idx:
            self._buckets[-1][1] += v
        else:
            self._buckets.append([idx, v])
        self._total += v

    def sum(self, t: float) -> float:
        self._expire(t)
        return self._total

    def rate(self, t: float) -> float:
        """Windowed sum per second of window span."""
        return self.sum(t) / self.window


# ------------------------------------------------------------------ the bus
class SignalBus:
    """Name → provider registry. ``read(name, key=None)`` calls the
    provider with ``key`` (a unit index, link id, SLO class, or stage name —
    signal-specific; ``None`` where the signal is scalar). Providers are
    plain callables, so live-view closures and streaming estimators share
    one namespace."""

    def __init__(self) -> None:
        self._providers: Dict[str, Callable[[Any], float]] = {}
        self._help: Dict[str, str] = {}

    def register(self, name: str, fn: Callable[[Any], float],
                 help: str = "") -> None:
        self._providers[name] = fn
        self._help[name] = help

    def has(self, name: str) -> bool:
        return name in self._providers

    def names(self) -> List[str]:
        return sorted(self._providers)

    def describe(self) -> Dict[str, str]:
        return dict(self._help)

    def read(self, name: str, key: Any = None) -> float:
        fn = self._providers.get(name)
        if fn is None:
            raise KeyError(f"unknown signal {name!r}; "
                           f"registered: {self.names()}")
        return fn(key)


# -------------------------------------------------------------- the monitor
class Monitor:
    """Streaming-estimator collector behind the telemetry probe interface.

    The runtime binds it exactly like the telemetry collector
    (``bind(clock, topo)``), forwards the same probe calls (via
    :class:`ProbeFanout` when both planes are on), and additionally calls
    :meth:`bind_live` with its ``RoutingView`` so the bus carries the live
    queue/laxity signals the migrated detectors read. A pure observer:
    every method only reads its arguments and the bound clock."""

    def __init__(self, spec: Optional[MonitorSpec] = None):
        self.spec = spec if spec is not None else MonitorSpec()
        self.bus = SignalBus()
        self._clock: Callable[[], float] = lambda: 0.0
        self.topo: Any = None
        self.t_first_decode = 0.0
        self._t_link = 0.0                     # last link sample time
        # cumulative counters (whole run)
        self.n_arrivals = 0
        self.n_admitted = 0
        self.n_done = 0
        self.n_met = 0
        self.n_shed = 0
        self.n_deferred = 0
        self.stage_submitted: Dict[str, int] = {}
        # rolling estimators
        w, b = self.spec.window, self.spec.buckets
        self._win_done = RollingWindow(w, b)
        self._win_met = RollingWindow(w, b)
        self._win_shed = RollingWindow(w, b)
        self._win_wall = RollingWindow(w, b)           # sampled link seconds
        self._win_link_util: Dict[int, RollingWindow] = {}   # util * dt
        self._win_link_cont: Dict[int, RollingWindow] = {}   # contended dt
        self._win_slack: Dict[str, RollingWindow] = {}       # slack-loss s
        # per-SLO-class quantile sketches ("all" aggregates every class)
        self.ttft_sketch: Dict[str, FixedBinSketch] = {}
        self.tpot_sketch: Dict[str, FixedBinSketch] = {}
        #: progress hook: called with this monitor every
        #: ``spec.sample_every`` finished requests (0 disables)
        self.on_sample: Optional[Callable[["Monitor"], None]] = None
        self._since_sample = 0
        self._register_signals()

    # -------------------------------------------------------------- binding
    def bind(self, clock: Callable[[], float], topo: Any,
             t_first_decode: float = 0.0) -> None:
        self._clock = clock
        self.topo = topo
        self.t_first_decode = t_first_decode

    def bind_live(self, view: Any) -> None:
        """Register the live-view signals over the runtime's RoutingView.

        These are the *exact* expressions the legacy ``queue_depth`` /
        ``laxity_debt`` detectors computed in-detector, registered as bus
        providers so bus-attached detectors trip/recover at byte-identical
        times (see ``tests/test_monitor.py``)."""
        bus = self.bus
        bus.register("queue.requests.cluster",
                     lambda key: float(view.total_queued()),
                     "queued prefill requests, cluster-wide")
        bus.register("queue.requests.unit",
                     lambda key: float(view.queued(key)),
                     "queued prefill requests at unit ``key``")
        bus.register("queue.tokens.cluster",
                     lambda key: float(sum(view.backlogs)),
                     "backlog tokens, cluster-wide")
        bus.register("queue.tokens.unit",
                     lambda key: float(view.backlogs[key]),
                     "backlog tokens at unit ``key``")

        def _laxity_debt(key: Any) -> float:
            now = view.now
            debt = 0.0
            for u in range(view.n_units):
                for it in view.queued_items(u):
                    debt += max(0.0, (now + it.ideal_ttft) - it.deadline)
            return debt

        bus.register("laxity.debt", _laxity_debt,
                     "summed already-lost slack of queued work (seconds)")

    # ----------------------------------------------------------- registry
    def _register_signals(self) -> None:
        bus = self.bus
        bus.register("slo.attainment", lambda key: self.rolling_attainment(),
                     "rolling admitted-attainment over the trailing window")
        bus.register("slo.attainment.cum",
                     lambda key: (self.n_met / self.n_done
                                  if self.n_done else 1.0),
                     "cumulative admitted-attainment since run start")
        bus.register("throughput.done",
                     lambda key: self._win_done.rate(self._clock()),
                     "finished requests per second, trailing window")
        bus.register("shed.rate",
                     lambda key: self._win_shed.rate(self._clock()),
                     "shed requests per second, trailing window")
        bus.register("link.util", self._sig_link_util,
                     "rolling mean utilization of link ``key``")
        bus.register("link.contended_share", self._sig_link_contended,
                     "share of the window link ``key`` spent contended")
        bus.register("slack_loss.rate", self._sig_slack_loss,
                     "per-stage-class deadline slack lost per second "
                     "(``key`` = stage name, e.g. 'P2D')")
        for q in (0.5, 0.9, 0.99):
            tag = f"p{int(q * 100)}"
            bus.register(f"ttft.{tag}",
                         lambda key, q=q: self._sig_quantile(
                             self.ttft_sketch, key, q),
                         f"TTFT {tag} for SLO class ``key`` ('all' default)")
            bus.register(f"tpot.{tag}",
                         lambda key, q=q: self._sig_quantile(
                             self.tpot_sketch, key, q),
                         f"TPOT {tag} for SLO class ``key`` ('all' default)")

    # ------------------------------------------------------ signal helpers
    def rolling_attainment(self) -> float:
        """Met/done over the trailing window; cumulative ratio before the
        first window fills (1.0 when nothing finished yet)."""
        t = self._clock()
        done = self._win_done.sum(t)
        if done <= 0.0:
            return self.n_met / self.n_done if self.n_done else 1.0
        return self._win_met.sum(t) / done

    def _sig_link_util(self, lid: Any) -> float:
        t = self._clock()
        wall = self._win_wall.sum(t)
        w = self._win_link_util.get(lid)
        if w is None or wall <= 0.0:
            return 0.0
        return w.sum(t) / wall

    def _sig_link_contended(self, lid: Any) -> float:
        t = self._clock()
        wall = self._win_wall.sum(t)
        w = self._win_link_cont.get(lid)
        if w is None or wall <= 0.0:
            return 0.0
        return w.sum(t) / wall

    def _sig_slack_loss(self, stage: Any) -> float:
        name = getattr(stage, "name", stage)
        w = self._win_slack.get(name)
        return w.rate(self._clock()) if w is not None else 0.0

    def _sig_quantile(self, sketches: Dict[str, FixedBinSketch],
                      key: Any, q: float) -> float:
        sk = sketches.get(key if key is not None else "all")
        return sk.quantile(q) if sk is not None else float("nan")

    def _sketch(self, sketches: Dict[str, FixedBinSketch],
                cls: str) -> FixedBinSketch:
        sk = sketches.get(cls)
        if sk is None:
            sk = sketches[cls] = FixedBinSketch(
                self.spec.sketch_lo, self.spec.sketch_hi,
                self.spec.sketch_bins)
        return sk

    def _observe(self, sketches: Dict[str, FixedBinSketch], cls: str,
                 x: float) -> None:
        self._sketch(sketches, cls).observe(x)
        self._sketch(sketches, "all").observe(x)

    # ------------------------------------------------ probe interface (sub)
    # Signatures mirror repro.core.telemetry.Telemetry exactly, so the
    # runtime's probe sites stay single-guard and a ProbeFanout can forward
    # each call verbatim. Methods the monitor has no estimator for are
    # deliberate no-ops (monitor-only runs must accept the full probe set).
    def on_arrival(self, item: Any, unit: int) -> None:
        if item.deferrals == 0:
            self.n_arrivals += 1

    def on_admitted(self, item: Any) -> None:
        self.n_admitted += 1

    def on_deferred(self, item: Any) -> None:
        self.n_deferred += 1

    def on_shed(self, item: Any) -> None:
        self.n_shed += 1
        self._win_shed.add(self._clock(), 1.0)

    def on_batch_started(self, bs: Any) -> None:
        pass

    def on_request_done(self, item: Any, bs: Any) -> None:
        t = self._clock()
        self.n_done += 1
        self._win_done.add(t, 1.0)
        budget = item.deadline - item.arrival
        if item.ttft is not None and item.ttft <= budget + 1e-9:
            self.n_met += 1
            self._win_met.add(t, 1.0)
        cls = getattr(item, "slo_class", "standard") or "standard"
        if item.ttft is not None:
            self._observe(self.ttft_sketch, cls, item.ttft)
        if self.on_sample is not None and self.spec.sample_every > 0:
            self._since_sample += 1
            if self._since_sample >= self.spec.sample_every:
                self._since_sample = 0
                self.on_sample(self)

    def on_decode_finished(self, sess: Any, now: float) -> None:
        """Decode-plane hook (``DecodePlane._finish``): one TPOT sample per
        finished session with >= 2 tokens (TPOT is undefined otherwise)."""
        if sess.tokens_done > 1:
            cls = getattr(sess.payload, "slo_class", "standard") \
                if sess.payload is not None else "standard"
            self._observe(self.tpot_sketch, cls or "standard", sess.tpot)

    def on_pruned(self, rid: int) -> None:
        pass

    def on_readmitted(self, rid: int) -> None:
        pass

    def compute_open(self, bs: Any, g: int, c: int) -> None:
        pass

    def compute_close(self, unit: int) -> None:
        pass

    def coll_wait(self, bid: int, dt: float) -> None:
        pass

    def red_run(self, order: Any, pruned: Any, n_batches: int) -> None:
        pass

    def flow_submitted(self, flow: Flow, stage_log: Any = None) -> None:
        """Per-stage submit counter. In a monitor-only run the runtime hands
        over the legacy stage log exactly as it does to the telemetry
        collector — the appended row is identical, so ``trace_stages``
        output never depends on which collector backs it."""
        if stage_log is not None:
            stage_log.append((flow.rid, flow.stage, flow.target_layer,
                              flow.size, flow.deadline))
        try:
            self.stage_submitted[flow.stage.name] += 1
        except KeyError:
            self.stage_submitted[flow.stage.name] = 1

    def flow_closed(self, flow: Flow, net: Any) -> None:
        if flow.deadline is None or flow.finished is None:
            return
        loss = max(0.0, flow.finished - flow.deadline)
        name = flow.stage.name
        w = self._win_slack.get(name)
        if w is None:
            w = self._win_slack[name] = RollingWindow(
                self.spec.window, self.spec.buckets)
        w.add(flow.finished, loss)

    def on_advance(self, net: Any, t: float) -> None:
        """Link sampling at ``link_dt`` pitch (same cadence discipline as
        the telemetry plane): accumulate utilization-weighted and contended
        link-seconds into the rolling windows."""
        if t - self._t_link < self.spec.link_dt:
            return
        sdt = t - self._t_link
        self._t_link = t
        self._win_wall.add(t, sdt)
        lr = getattr(net, "_link_rate", None)
        if not lr:
            return
        cap = self.topo.capacity
        thr = self.spec.contended_util
        for lid, used in lr.items():
            if used <= 0.0:
                continue
            w = self._win_link_util.get(lid)
            if w is None:
                w = self._win_link_util[lid] = RollingWindow(
                    self.spec.window, self.spec.buckets)
            w.add(t, (used / cap[lid]) * sdt)
            if used >= thr * cap[lid]:
                wc = self._win_link_cont.get(lid)
                if wc is None:
                    wc = self._win_link_cont[lid] = RollingWindow(
                        self.spec.window, self.spec.buckets)
                wc.add(t, sdt)

    # ------------------------------------------------------------- reporting
    def links_seen(self):
        """Link ids that have carried traffic (keys for ``link.util`` /
        ``link.contended_share`` bus reads)."""
        return list(self._win_link_util.keys())

    def snapshot(self) -> Dict[str, float]:
        """Headline signals at the current event time (progress lines,
        examples)."""
        return {
            "t": self._clock(),
            "n_done": self.n_done,
            "n_shed": self.n_shed,
            "n_deferred": self.n_deferred,
            "attainment": self.bus.read("slo.attainment"),
            "attainment_cum": self.bus.read("slo.attainment.cum"),
            "done_rate": self.bus.read("throughput.done"),
            "ttft_p99": self.bus.read("ttft.p99"),
        }


# ------------------------------------------------------------------- fanout
class ProbeFanout:
    """Forward each runtime probe call to both collectors.

    The runtime keeps ONE guard per probe site (``if self._probe is not
    None``); when telemetry and monitor are both attached this object is the
    probe target and replays every call on each. ``flow_submitted`` is
    special-cased so the legacy stage-log row is appended exactly once (by
    the telemetry collector)."""

    def __init__(self, telemetry: Any, monitor: Monitor):
        self.telemetry = telemetry
        self.monitor = monitor

    def flow_submitted(self, flow: Flow, stage_log: Any = None) -> None:
        self.telemetry.flow_submitted(flow, stage_log)
        self.monitor.flow_submitted(flow, None)

    def __getattr__(self, name: str):
        tf = getattr(self.telemetry, name)
        mf = getattr(self.monitor, name, None)
        if mf is None or not callable(tf):
            return tf

        def fan(*a: Any, **kw: Any) -> Any:
            out = tf(*a, **kw)
            mf(*a, **kw)
            return out

        self.__dict__[name] = fan          # cache per-instance
        return fan
