"""The train step (``repro.training.trainer``'s counterpart): one forward
and backward of ``Model.loss``, then ``adamw_update``.

A ``TrainState`` holds the model's own parameter tensors by name, so the
update in place is what the next step's forward reads. The data stream is
stateless given (seed, step) (``launch.train.synthetic_batch``) and every
operation on the train path sums in a fixed order, so a run resumed from a
checkpoint continues bit for bit on the CPU; on the card the attention
backward has no atomics and the embedding's backward is ``F.embedding``'s.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..launch.shardings import grad_sum_axes, model_splits
from ..models.convert import jax_ndim
from ..models.lm import Model
from ..models.sharding import ShardCtx, all_reduce
from .optim import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "make_train_step", "init_train_state"]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the model's parameters, by name
    opt: AdamWState
    step: int


def init_train_state(model: Model, generator: torch.Generator,
                     cfg: AdamWConfig = AdamWConfig()) -> TrainState:
    """Draw the model's weights from ``generator``, turn its gradients on
    and start the optimizer at step 0."""
    model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=adamw_init(params, cfg), step=0)


#: float32 values a gradient all-reduce carries at once
BUCKET = 1 << 26


def sync_grads(grads: Dict[str, torch.Tensor],
               sum_axes: Dict[str, Tuple[str, ...]],
               ctx: ShardCtx) -> Dict[str, torch.Tensor]:
    """Each gradient summed over its ``sum_axes`` (``launch.shardings.
    grad_sum_axes``) in float32: the gradients of one axis tuple flattened
    into buckets of at most ``BUCKET`` values, one ``all_reduce`` a bucket,
    in the parameters' order on every rank. Gradients with no axes are left
    as they are."""
    out = dict(grads)
    groups: Dict[Tuple[str, ...], list] = {}
    for n, axes in sum_axes.items():
        if axes:
            groups.setdefault(axes, []).append(n)
    for axes, names in groups.items():
        start = 0
        while start < len(names):
            stop, size = start, 0
            while stop < len(names) and (stop == start or size +
                                         grads[names[stop]].numel() <= BUCKET):
                size += grads[names[stop]].numel()
                stop += 1
            chunk = names[start:stop]
            flat = all_reduce(torch.cat([grads[n].float().reshape(-1)
                                         for n in chunk]), ctx, axes)
            for n, g in zip(chunk, flat.split([grads[n].numel()
                                               for n in chunk])):
                out[n] = g.view(grads[n].shape)
            start = stop
    return out


def make_train_step(model: Model, cfg: AdamWConfig = AdamWConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    ``metrics = {"loss", "grad_norm"}`` as 0-dim float32 tensors. A
    parameter the loss does not reach (an MTP head without ``labels2``) gets
    a zero gradient, as ``jax.grad`` gives it. Weight decay follows the rank
    of the JAX leaf (``convert.jax_ndim``), so a stacked layer's norm gain
    is decayed as JAX decays it.

    Under a mesh (``model.ctx``) ``batch`` is the rank's rows
    (``launch.shardings.shard_batch``), the loss the whole batch's mean;
    each gradient is summed in float32 over the data axes and, for a
    replicated parameter only the rank's share of the work reaches, over
    "model" (``sync_grads``), the norm is the logical gradient's, and AdamW
    updates each rank's shards."""
    decay = {n: jax_ndim(n, p) >= 2 for n, p in model.named_parameters()}
    ctx, shards = model.ctx, model_splits(model)
    sum_axes = {n: grad_sum_axes(n, s, model.cfg, ctx)
                for n, s in shards.items()}

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        for p in params.values():
            p.grad = None
        loss = model.loss(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grads = sync_grads(grads, sum_axes, ctx)
        params, opt, gnorm = adamw_update(grads, state.opt, params, cfg,
                                          decay, shards, ctx)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss.detach().float(), "grad_norm": gnorm}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step
