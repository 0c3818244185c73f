"""Serving cells: an open loop of bursts through one ``DisaggServer``.

A cell offers its bursts at a rate fixed in its file; above the rate the
server sustains, the window measures the tokens it serves a second (a
request's prompt once its first token is on the host, each output token
as it comes), and the tails of time to first token and between tokens,
which swing with the growing queue, are per-layer readings.

One server (the MFS policy, the cell's prefill units, decode slots and
page pool) lives for the whole run, so its prefix index carries across
bursts. Each burst is one ``DisaggServer.serve`` call with
``decode_steps`` at the burst's longest output, so every sequence of the
burst finishes in its call. The harness sends a burst at its due time,
or at once when it is late; a request's time to first token runs from
its due time to the host holding its first token (``ServingEngine.
prefill`` returns after ``int(argmax)``, a host read), and a gap between
tokens from one token on the host to the next (``DecodeBatch.step`` ends
in ``.cpu()``).

The modeled cluster's clock must not depend on how fast the card ran: a
burst's modeled arrival is its due time after the modeled clock's value
when the warm-up ended, or the modeled clock's value after the previous
call where that is later (``EventQueue`` refuses an arrival in its past).
Both depend on the seed alone. The share of requests that met the
modeled SLO is over the cell's first ``slo_bursts`` bursts, whatever the
window reached: those it did not reach are served after it, untimed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

from ..lib import program, traffic, weights
from ..lib.stats import latencies_with_unserved
from ..lib.trace import DeviceTrace, HostSpans
from . import common

SERVE_SPAN = "DisaggServer.serve, outside the engine"
PREFILL_SPAN = "ServingEngine.prefill"
DECODE_SPAN = "DecodeBatch.step"
WAIT_SPAN = "waiting for the next burst's due time"


class _Recorder:
    """Host clock around the engines' prefill and the decode step of one
    server (instance attributes wrap the bound methods; the program is
    not edited)."""

    def __init__(self, server: Any, spans: HostSpans, ctx) -> None:
        self.spans = spans
        self.rid_of: Dict[int, int] = {}      # id(tokens) -> rid
        self.first_ns: Dict[int, int] = {}
        self.last_ns: Dict[int, int] = {}
        self.token_ns: List[int] = []          # each output token's time
        self.gaps: List[tuple] = []            # (end ns, gap ns)
        self.prefills: List[tuple] = []        # (t0, t1, new tokens, prefix)
        self.steps: List[tuple] = []           # (t0, t1, keys of each slot)
        for eng in server.engines:
            eng.prefill = self._prefill(ctx.hook("prefill", eng.prefill))
        self.decoder = server.decoder
        server.decoder.step = self._step(ctx.hook("step",
                                                  server.decoder.step))

    def _prefill(self, inner):
        def prefill(tokens, *a, **kw):
            t0 = time.perf_counter_ns()
            out = inner(tokens, *a, **kw)
            t1 = time.perf_counter_ns()
            self.spans.add(PREFILL_SPAN, t0, t1)
            prefix = kw.get("prefix_len", 0) \
                if kw.get("prefix_cache") is not None else 0
            self.prefills.append((t0, t1, len(tokens) - prefix, prefix))
            rid = self.rid_of.get(id(tokens))
            if rid is not None:
                self.first_ns[rid] = self.last_ns[rid] = t1
                self.token_ns.append(t1)
            return out
        return prefill

    def _step(self, inner):
        def step():
            keys = [s.pos + 1 for s in self.decoder.slots.values()]
            t0 = time.perf_counter_ns()
            out = inner()
            t1 = time.perf_counter_ns()
            self.spans.add(DECODE_SPAN, t0, t1)
            self.steps.append((t0, t1, keys))
            for rid in out:
                if rid in self.last_ns:
                    self.gaps.append((t1, t1 - self.last_ns[rid]))
                    self.last_ns[rid] = t1
                    self.token_ns.append(t1)
            return out
        return step


def run(ctx) -> Dict[str, Any]:
    from repro_torch.core import make_policy
    from repro_torch.serving import DisaggConfig, DisaggServer, ServeRequest

    P, cfg, mix, dev = ctx.params, ctx.cfg, ctx.mix, ctx.device
    V = cfg["vocab_size"]
    hi = V - P["warmup_vocab"]       # the window's ids; warm-up's above
    model = program.build(cfg, weights.make(cfg, ctx.seed, dev), dev)
    server = DisaggServer(model, make_policy(P["policy"]), DisaggConfig(
        n_prefill_units=P["prefill_units"], decode_slots=P["decode_slots"],
        decode_capacity=P["decode_capacity"], page_size=P["page_size"],
        n_pages=P["pages"]))
    spans = HostSpans()
    rec = _Recorder(server, spans, ctx)
    results: Dict[int, Any] = {}

    def serve(burst, base, rid0=0):
        arrival = max(base + burst.due, server.runtime.evq.now)
        reqs = [ServeRequest(rid=rid0 + r.rid, arrival=arrival,
                             tokens=r.tokens, max_new=r.max_new)
                for r in burst.requests]
        for q in reqs:
            rec.rid_of[id(q.tokens)] = q.rid
        t0 = time.perf_counter_ns()
        out = server.serve(reqs, decode_steps=max(q.max_new for q in reqs))
        t1 = time.perf_counter_ns()
        spans.add(SERVE_SPAN, t0, t1)
        for q, r in zip(reqs, out):
            results[q.rid] = r
        return t0, t1, len(reqs)

    # warm-up on the mix's own shapes, from ids the window never sends
    # (so nothing it leaves in the prefix index matches the window's)
    warm = traffic.serve_plan(mix, 0, P["warmup_bursts"] / 2.0, 2.0,
                              V - hi)
    for b in warm:
        for r in b.requests:
            r.tokens = r.tokens + hi
        serve(b, server.runtime.evq.now, rid0=-(1 << 40))
    common.sync(dev)
    plan = traffic.serve_plan(mix, ctx.seed, P["bursts_per_s"],
                              ctx.seconds, hi)
    due_of = {r.rid: b.due for b in plan for r in b.requests}
    req_of = {r.rid: r for b in plan for r in b.requests}
    base = server.runtime.evq.now
    rec.gaps.clear()
    rec.token_ns.clear()
    rec.prefills.clear()
    rec.steps.clear()
    spans.spans.clear()
    setup_s = time.perf_counter() - ctx.t_start

    calls, lag = [], []
    tracer = DeviceTrace() if ctx.trace else None
    t0 = time.perf_counter_ns()
    if tracer is not None:
        tracer.__enter__()
        t0 = tracer.t0_ns
    end = t0 + int(ctx.seconds * 1e9)
    left = list(plan)
    while left and time.perf_counter_ns() < end:
        b = left.pop(0)
        due = t0 + int(b.due * 1e9)
        w0 = time.perf_counter_ns()
        common.wait_until(due)
        spans.add(WAIT_SPAN, w0, time.perf_counter_ns())
        lag.append((time.perf_counter_ns() - due) / 1e9)
        calls.append(serve(b, base))
    common.wait_until(end)
    if tracer is not None:
        tracer.__exit__(None, None, None)
    # the modeled SLO's bursts the window did not reach
    for b in left:
        if b.index < P["slo_bursts"]:
            serve(b, base)
    peak = common.peak_bytes(dev)

    rids = sorted(due_of)
    ttft = latencies_with_unserved(
        [rec.first_ns.get(r) for r in rids],
        [t0 + int(due_of[r] * 1e9) for r in rids], end)
    ttft = [t / 1e9 for t in ttft]
    served_in = [r for r in rids if rec.first_ns.get(r, end + 1) <= end]
    slo = [r for r in rids if req_of[r].burst < P["slo_bursts"]]
    finished = [r for r in served_in if rec.last_ns[r] <= end
                and len(results[r].tokens) == req_of[r].max_new]
    record = {
        "setup_s": setup_s,
        "attempted": len(rids),
        "failed": sum(results[r].shed for r in rids if r in results),
        "device": {"memory_peak_bytes": peak},
        "cfg": cfg, "spans": spans, "trace": tracer,
        "serve": {
            "ttft_s": ttft,
            "gaps_s": [g / 1e9 for t, g in rec.gaps if t <= end],
            "met_slo": [bool(results[r].met_slo) for r in slo],
            "served_tokens": sum(len(req_of[r].tokens) for r in served_in)
            + sum(t <= end for t in rec.token_ns),
            "reused": sum(results[r].reused_tokens for r in served_in),
            "prompt_tokens": sum(len(req_of[r].tokens) for r in served_in),
            "prefill_calls": rec.prefills,
            "step_calls": rec.steps,
            "calls": [c for c in calls if c[1] <= end],
            "t0_ns": t0, "end_ns": end,
            "lag_s": lag, "bursts": len(plan), "unstarted": len(left),
        },
    }
    # the check: a sample of the requests finished in the window, the
    # longest among them, against the reference once the program is gone
    seqs = [(req_of[r].tokens, list(results[r].tokens)) for r in finished]
    del server, model, rec, results
    common.free(dev)
    return common.check_served(record, cfg, ctx.seed, dev, seqs,
                               P["check_requests"])
