"""Steady decode cells of an MLA and expert model (DeepSeek-V3's files):
the decode unit alone, a closed loop over a full batch that has been
running for a while.

Set-up draws the weights (``lib/mla_moe.py``), prefills each prompt of the
pool through ``ServingEngine.prefill`` in chunks of at most
``prefill_chunk`` tokens, each a suffix prefill over the cache built so
far (so that MLA's float32 scores of a long prompt fit), and fills every
slot of one ``DecodeBatch`` with ``DecodeBatch.add``. The first fill's
k-th sequence already holds (k + 0.5) / slots of its output: token ids
drawn from the seed, prefilled after its prompt's cache the same way, so
the window meets caches spread over their lengths. The window steps the
batch; a slot that retires is refilled at once by ``add`` of the next
prompt's cache of the pool, cycling through it. A gap between tokens runs
from one token of a sequence on the host (``DecodeBatch.step`` ends in
``.cpu()``) to its next, the first from the hand-over.

The record has the decode driver's layout (``record["decode"]``), so the
decode readers read it. The check compares the served tokens of a sample
of the sequences finished in the window with ``reference/mla_moe.py``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..lib import mla_moe, traffic
from ..lib.trace import DeviceTrace, HostSpans
from ..reference import dense
from ..reference import mla_moe as reference
from . import common

STEP_SPAN = "DecodeBatch.step"
ADD_SPAN = "DecodeBatch.add"


def chunked_prefill(engine, tokens: np.ndarray, chunk: int, cache=None,
                    start: int = 0) -> Tuple[int, Any]:
    """(first token, cache) of ``tokens``, whose first ``start`` positions
    ``cache`` holds, prefilled ``chunk`` positions at a time, each chunk a
    suffix prefill over the cache before it."""
    first = None
    for a in range(start, len(tokens), chunk):
        b = min(a + chunk, len(tokens))
        first, cache, _ = engine.prefill(tokens[:b], prefix_cache=cache,
                                         prefix_len=a)
    return first, cache


def steady_start(mix: Dict[str, Any], pool, seed: int, vocab: int,
                 slots: int) -> List[np.ndarray]:
    """The tokens the first fill's k-th sequence has already produced:
    (k + 0.5) / ``slots`` of its output (at least 2 left to decode),
    ids drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for k in range(slots):
        s = pool[k % len(pool)]
        n = min(int(round(s.max_new * (k + 0.5) / slots)), s.max_new - 2)
        out.append(rng.integers(0, vocab, size=max(n, 0), dtype=np.int64))
    return out


def run(ctx) -> Dict[str, Any]:
    from repro_torch.serving import DecodeBatch, ServingEngine

    P, cfg, mix, dev = ctx.params, ctx.cfg, ctx.mix, ctx.device
    mla_moe.arch(cfg)          # a program that cannot build it fails here
    model = mla_moe.build(cfg, mla_moe.make(cfg, ctx.seed, dev), dev)
    engine = ServingEngine(model)
    chunk = P["prefill_chunk"]
    pool = traffic.decode_pool(mix, ctx.seed, cfg["vocab_size"],
                               P["capacity"])
    caches = [chunked_prefill(engine, s.tokens, chunk) for s in pool]
    ahead = steady_start(mix, pool, ctx.seed, cfg["vocab_size"], P["slots"])
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
        prompt, out = s.tokens, s.max_new
        if k < P["slots"] and len(ahead[k]):
            prompt = np.concatenate([s.tokens, ahead[k]])
            first, cache = chunked_prefill(engine, prompt, chunk, cache,
                                           len(s.tokens))
            out = s.max_new - len(ahead[k])
        t0 = time.perf_counter_ns()
        decoder.add(k, cache, len(prompt), first, max_new=out)
        t1 = time.perf_counter_ns()
        spans.add(ADD_SPAN, t0, t1)
        seqs[k] = {"prompt": prompt, "tokens": [first], "last": t1,
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
    checked = [(seqs[k]["prompt"], seqs[k]["tokens"]) for k in done]
    del decoder, engine, caches, model, step, one_step, admit
    common.free(dev)
    return check_served(record, cfg, ctx.seed, dev, checked,
                        P["check_sequences"])


def served_gap(cfg: Dict[str, Any], seed: int, device: str,
               seqs: Sequence[Tuple[np.ndarray, Sequence[int]]],
               precision: str = "f32") -> float:
    """``common.served_gap`` against ``reference/mla_moe.py``: the widest
    gap by which a served token's logit lies below the reference's best,
    over every served token of ``seqs``; with ``precision="fp8"`` the
    control's tokens (the float8 reference's first at each position)."""
    dense.exact()
    leaves = mla_moe.make(cfg, seed, device)
    worst = 0.0
    for prompt, served in seqs:
        toks = torch.as_tensor(np.concatenate(
            [np.asarray(prompt), np.asarray(served[:-1], np.int64)]),
            device=device)
        at = list(range(len(prompt) - 1, len(prompt) - 1 + len(served)))
        ref = reference.logits_at(cfg, leaves, toks, at)
        if precision == "f32":
            chosen = torch.as_tensor(list(served), device=device)
        else:
            chosen = reference.logits_at(cfg, leaves, toks, at,
                                         precision).argmax(-1)
        worst = max(worst, dense.widest_gap(ref, chosen))
    return worst


def check_served(record: Dict[str, Any], cfg: Dict[str, Any], seed: int,
                 device: str, finished, n: int) -> Dict[str, Any]:
    """``common.check_served`` against ``reference/mla_moe.py``."""
    if not finished:
        record["compared"] = {"logit_gap": float("nan")}
        record["checked"] = []
        return record
    longest = int(np.argmax([len(p) + len(s) for p, s in finished]))
    pick = [finished[i] for i in common.sample(len(finished), longest, n,
                                               seed)]
    record["compared"] = {"logit_gap": served_gap(cfg, seed, device, pick)}
    record["checked"] = pick
    return record


def control(ctx, record) -> Dict[str, float]:
    """The control's reading on the sequences ``record`` checked."""
    return {"logit_gap": served_gap(ctx.cfg, ctx.seed, ctx.device,
                                    record["checked"], "fp8")}
