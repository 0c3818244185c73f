"""Training cells: warm steps of ``training.trainer.make_train_step``.

Set-up builds one model and one ``TrainState`` (the benchmark's weights,
zero AdamW moments in float32) and drives that same object through its
first three steps with the window's own call and feed: batches of rows
that all differ, drawn from the seed. Those three steps build every
kernel and are what the reference checks: each step's loss, each leaf's
first gradient as the optimizer got it (its first moment after one step
over ``1 - b1`` and over the clip scale of the reported norm) and each
leaf's change after the three. The window then
goes on from the same state and runs whole steps, each ending in a read
of its loss, until ``--seconds`` have passed: the rate is the tokens of
those steps over the time to the end of the last. With ``--trace 1``
the first ``trace_steps`` steps of the window are traced (the steps
after them, untraced, give ``train_mfu``), the host's
optimizer's device time taken by CUDA events around each call of
``trainer.adamw_update`` (recorded on the stream before and after it; the
update's kernels run back to back, so the span is their time).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Any, Dict

import torch

from ..lib import program, traffic, weights
from ..lib.trace import DeviceTrace, HostSpans
from ..reference import dense
from . import common

STEP_SPAN = "train step"
SMALL_GRAD = 1e-3       # of the median leaf's: a leaf moved by round-off


def _adamw_config(recipe: Dict[str, Any]):
    from repro_torch.training.optim import AdamWConfig
    return AdamWConfig(lr=recipe["lr"], b1=recipe["b1"], b2=recipe["b2"],
                       eps=recipe["eps"], weight_decay=recipe["weight_decay"],
                       clip_norm=recipe["clip_norm"], warmup=recipe["warmup"],
                       state_dtype=torch.float32)


def _gap(got: Dict[str, float], want: Dict[str, float], names) -> float:
    """The worst leaf's |got - want| over the larger of want and the
    median leaf's want."""
    med = statistics.median(want.values())
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def run(ctx) -> Dict[str, Any]:
    from repro_torch.training import trainer
    from repro_torch.training.optim import adamw_init

    P, cfg, mix, dev = ctx.params, ctx.cfg, ctx.mix, ctx.device
    recipe = cfg["train"]
    B, T = int(mix["batch"]), int(mix["seq"])
    p0 = weights.make(cfg, ctx.seed, dev)
    model = program.build(cfg, p0, dev)
    model.requires_grad_(True)
    places = program.leaf_map(model, cfg)
    params = dict(model.named_parameters())
    acfg = _adamw_config(recipe)
    state = trainer.TrainState(params, adamw_init(params, acfg), 0)
    step = ctx.hook("step", trainer.make_train_step(model, acfg))
    toks = traffic.train_tokens(mix, ctx.seed, cfg["vocab_size"], dev)

    def batch(i: int):
        t = toks[i % toks.shape[0]]
        return ctx.hook("batch", {"tokens": t[:, :-1], "labels": t[:, 1:]})

    name_of = {id(p): n for n, p in params.items()}
    losses, first = [], {}
    for i in range(P["checked_steps"]):
        state, met = step(state, batch(i))
        losses.append(float(met["loss"]))
        if i == 0:
            # m = (1 - b1) * clip scale * gradient after one step
            scale = min(1.0, recipe["clip_norm"]
                        / (float(met["grad_norm"]) + 1e-9))
            with torch.no_grad():
                first = {k: float(state.opt.m[name_of[id(p)]][idx].float()
                                  .norm()) / (1 - recipe["b1"]) / scale
                         for k, (p, idx) in places.items()}
    with torch.no_grad():
        change = {k: float((p[idx].float() - p0[k].float()).norm())
                  for k, (p, idx) in places.items()}
    del p0
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    spans = HostSpans()
    tracer = DeviceTrace() if ctx.trace else None
    inner_update = trainer.adamw_update
    marks = []

    def timed_update(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = inner_update(*a, **kw)
        ev[1].record()
        marks.append(ev)
        return out

    n_steps, k, traced_steps, after = 0, P["checked_steps"], 0, None
    t0 = time.perf_counter_ns()
    end = t0 + int(ctx.seconds * 1e9)
    while True:
        if tracer is not None and n_steps == 0:
            trainer.adamw_update = timed_update
            tracer.__enter__()
        s0 = time.perf_counter_ns()
        state, met = step(state, batch(k))
        loss = float(met["loss"])
        s1 = time.perf_counter_ns()
        spans.add(STEP_SPAN, s0, s1)
        k += 1
        n_steps += 1
        if not math.isfinite(loss):
            break
        if tracer is not None and n_steps == P["trace_steps"]:
            tracer.__exit__(None, None, None)
            trainer.adamw_update = inner_update
            traced_steps = n_steps
            after = time.perf_counter_ns()
        if s1 >= end and (tracer is None or traced_steps):
            break
    opt_s = sum(a.elapsed_time(b) for a, b in marks) / 1e3
    elapsed = (s1 - t0) / 1e9
    peak = common.peak_bytes(dev)
    record = {
        "setup_s": setup_s,
        "attempted": n_steps,
        "failed": 0 if math.isfinite(loss) else 1,
        "device": {"memory_peak_bytes": peak},
        "cfg": cfg, "spans": spans, "trace": tracer,
        "train": {"steps": n_steps, "tokens": n_steps * B * T,
                  "elapsed_s": elapsed, "batch": B, "seq": T,
                  "traced_steps": traced_steps, "optimizer_s": opt_s,
                  "untraced_steps": n_steps - traced_steps,
                  "untraced_s": (s1 - after) / 1e9 if after else elapsed},
    }
    del state, step, model, params, places, met
    common.free(dev)
    ref = reference(cfg, ctx.seed, toks[:P["checked_steps"]], dev)
    got = {"losses": losses, "first": first, "change": change}
    record["compared"] = compare(got, ref)
    med = statistics.median(ref["first"].values())
    record["readings"] = {"losses": losses, "ref_losses": ref["losses"],
                          "left_out": sorted(n for n, g in ref["first"].items()
                                             if g < SMALL_GRAD * med)}
    return record


def compare(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The three compared numbers: the gap of the first step's loss, and
    by the worst leaf the gap of the first gradient's norm and of the
    change's norm after the checked steps (leaves whose reference
    gradient is under SMALL_GRAD of the median leaf's left out of the
    change: round-off moves them). The later steps' losses are not
    compared: AdamW's first update moves every weight by the learning
    rate times the sign of its gradient, so a gradient that is nought to
    rounding flips a weight by twice the rate, and bf16 and float32 part
    there by a few thousandths of the loss that no fault needs to
    explain; they are kept as readings."""
    names = sorted(ref["first"])
    med = statistics.median(ref["first"].values())
    moved = [n for n in names if ref["first"][n] >= SMALL_GRAD * med]
    return {"first_loss_gap": abs(got["losses"][0] - ref["losses"][0]),
            "first_grad_gap": _gap(got["first"], ref["first"], names),
            "change_gap": _gap(got["change"], ref["change"], moved)}


def reference(cfg: Dict[str, Any], seed: int, batches: torch.Tensor,
              device: str, precision: str = "f32") -> Dict[str, Any]:
    """The reference's losses, first clipped gradient a leaf and change a
    leaf after ``len(batches)`` steps of the configuration's recipe from
    the weights of ``seed``."""
    dense.exact()

    def initial():
        leaves = weights.make(cfg, seed, device)
        if precision == "fp8":
            leaves = {n: dense.fp8_round(t.float())
                      for n, t in leaves.items()}
        return leaves
    leaves = initial()
    m = {n: torch.zeros(t.shape, dtype=torch.float32, device=device)
         for n, t in leaves.items()}
    v = {n: torch.zeros_like(x) for n, x in m.items()}
    losses, first = [], {}
    for i in range(batches.shape[0]):
        loss, grads = dense.gradients(cfg, leaves, batches[i], precision)
        _, norms = dense.adamw(leaves, grads, m, v, i + 1, cfg["train"],
                               precision)
        del grads
        losses.append(loss)
        if i == 0:
            first = norms
    del m, v
    p0 = initial()
    change = {n: float((leaves[n].float() - p0[n].float()).norm())
              for n in leaves}
    return {"losses": losses, "first": first, "change": change}
