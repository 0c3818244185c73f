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

from typing import Any, Dict, NamedTuple

import torch

from ..models.convert import jax_ndim
from ..models.lm import Model
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


def make_train_step(model: Model, cfg: AdamWConfig = AdamWConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    ``metrics = {"loss", "grad_norm"}`` as 0-dim float32 tensors. A
    parameter the loss does not reach (an MTP head without ``labels2``) gets
    a zero gradient, as ``jax.grad`` gives it. Weight decay follows the rank
    of the JAX leaf (``convert.jax_ndim``), so a stacked layer's norm gain
    is decayed as JAX decays it."""
    decay = {n: jax_ndim(n, p) >= 2 for n, p in model.named_parameters()}

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        for p in params.values():
            p.grad = None
        loss = model.loss(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        params, opt, gnorm = adamw_update(grads, state.opt, params, cfg,
                                          decay)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss.detach().float(), "grad_norm": gnorm}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step
