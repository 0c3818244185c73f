"""Faults planted underneath the timed path, for the checks that a broken
run comes out not correct (``tests/test_pb_faults.py``) and for reading
what a fault does to the compared numbers on the card
(``calibrate.py --fault``). Each is a ``Ctx.fault``: called with the
point where a driver hands over a program object, it returns the object
to use in its place."""
from __future__ import annotations

import torch


def token_altered(vocab: int):
    """Every token the engine's prefill or the decode step produces comes
    out one id higher."""
    def fault(point, fn):
        if point == "prefill":
            def altered(*a, **kw):
                first, cache, logits = fn(*a, **kw)
                return (first + 1) % vocab, cache, logits
            return altered
        if point == "step":
            def altered_step():
                return {rid: (tok + 1) % vocab for rid, tok in fn().items()}
            return altered_step
        return fn
    return fault


def state_unchanged(point, fn):
    """A training step that computes its loss and gradients and then
    returns its state as it found it: parameters and moments kept."""
    if point != "step":
        return fn

    def no_update(state, batch):
        keep = {n: p.detach().clone() for n, p in state.params.items()}
        moments = [{n: t.clone() for n, t in d.items()}
                   for d in (state.opt.m, state.opt.v)]
        _, met = fn(state, batch)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(keep[n])
            for d, saved in zip((state.opt.m, state.opt.v), moments):
                for n, t in d.items():
                    t.copy_(saved[n])
        return state, met
    return no_update


def half_batch(point, batch):
    """Half of every training batch left out, the mean taken over the
    rest."""
    if point != "batch":
        return batch
    n = batch["tokens"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}
