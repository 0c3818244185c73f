"""Decode cells: the decode unit alone, a closed loop over a full batch.

Set-up prefills a pool of prompts through ``ServingEngine.prefill`` (in a
deployment, the prefill units' work, elsewhere) and fills every slot of
one ``DecodeBatch`` with ``DecodeBatch.add``. The window steps the batch;
a slot that retires is refilled at once by ``add`` of the next cache of
the pool, cycling through it, so the batch stays full. The first fill's
k-th sequence is given (k + 1) / slots of its output, so that the batch
starts with its sequences spread over their progress, as a batch that
has run for a while holds them, and not all finishing together. A gap between
tokens runs from one token of a sequence on the host (``DecodeBatch.
step`` ends in ``.cpu()``) to its next, the first from the hand-over.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List


from ..lib import program, traffic, weights
from ..lib.trace import DeviceTrace, HostSpans
from . import common

STEP_SPAN = "DecodeBatch.step"
ADD_SPAN = "DecodeBatch.add"


def run(ctx) -> Dict[str, Any]:
    from repro_torch.serving import DecodeBatch, ServingEngine

    P, cfg, mix, dev = ctx.params, ctx.cfg, ctx.mix, ctx.device
    model = program.build(cfg, weights.make(cfg, ctx.seed, dev), dev)
    engine = ServingEngine(model)
    pool = traffic.decode_pool(mix, ctx.seed, cfg["vocab_size"],
                               P["capacity"])
    caches = []
    for s in pool:
        first, cache, _ = engine.prefill(s.tokens)
        caches.append((first, cache))
    decoder = DecodeBatch(model, capacity=P["capacity"],
                          max_slots=P["slots"])
    step = ctx.hook("step", decoder.step)
    spans = HostSpans()
    seqs: Dict[int, Dict[str, Any]] = {}     # admission id -> its record
    nxt = [0]

    def admit() -> None:
        k = nxt[0]
        nxt[0] += 1
        s = pool[k % len(pool)]
        first, cache = caches[k % len(pool)]
        out = s.max_new if k >= P["slots"] else \
            max(2, round(s.max_new * (k + 1) / P["slots"]))
        t0 = time.perf_counter_ns()
        decoder.add(k, cache, len(s.tokens), first, max_new=out)
        t1 = time.perf_counter_ns()
        spans.add(ADD_SPAN, t0, t1)
        seqs[k] = {"pool": k % len(pool), "tokens": [first], "last": t1,
                   "done": None}

    steps: List[tuple] = []
    gaps: List[tuple] = []

    def one_step() -> None:
        keys = [sl.pos + 1 for sl in decoder.slots.values()]
        t0 = time.perf_counter_ns()
        out = step()
        t1 = time.perf_counter_ns()
        spans.add(STEP_SPAN, t0, t1)
        steps.append((t0, t1, keys))
        live = {sl.rid for sl in decoder.slots.values()}
        for rid, tok in out.items():
            rec = seqs[rid]
            rec["tokens"].append(tok)
            gaps.append((t1, t1 - rec["last"]))
            rec["last"] = t1
            if rid not in live:
                rec["done"] = t1
        for _ in range(P["slots"] - decoder.n_active):
            admit()

    for _ in range(P["slots"]):
        admit()
    for _ in range(P["warmup_steps"]):
        one_step()
    common.sync(dev)
    steps.clear()
    gaps.clear()
    spans.spans.clear()
    setup_s = time.perf_counter() - ctx.t_start

    tracer = DeviceTrace() if ctx.trace else None
    t0 = time.perf_counter_ns()
    if tracer is not None:
        tracer.__enter__()
        t0 = tracer.t0_ns
    end = t0 + int(ctx.seconds * 1e9)
    while time.perf_counter_ns() < end:
        one_step()
    if tracer is not None:
        tracer.__exit__(None, None, None)
    peak = common.peak_bytes(dev)

    done = [k for k, r in seqs.items()
            if r["done"] is not None and t0 <= r["done"] <= end]
    record = {
        "setup_s": setup_s,
        "attempted": len(done),
        "failed": 0,
        "device": {"memory_peak_bytes": peak},
        "cfg": cfg, "spans": spans, "trace": tracer,
        "decode": {
            "gaps_s": [g / 1e9 for t, g in gaps if t <= end],
            "step_calls": steps,
            "t0_ns": t0, "end_ns": end,
        },
    }
    checked = [(pool[seqs[k]["pool"]].tokens, seqs[k]["tokens"])
               for k in done]
    del decoder, engine, caches, model, step, one_step, admit
    common.free(dev)
    return common.check_served(record, cfg, ctx.seed, dev, checked,
                               P["check_sequences"])
