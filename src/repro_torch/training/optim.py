"""AdamW with global-norm clipping, with the JAX package's semantics
(``repro.training.optim``), over dicts of named tensors.

It differs from ``torch.optim.AdamW``, so it is its own code: the gradient
is clipped to a global norm first (the pre-clip norm is reported); the
warmup ``lr * min(1, (step + 1) / warmup)`` reads the step before the
increment; weight decay is added to the normalised update, not to the
gradient or as a separate shrink of the weights, and only for leaves of
rank 2 or more; the math is float32 whatever the parameter's dtype, the
moments are kept in ``state_dtype`` and the parameter is cast back.

The JAX update is functional; here the parameters and the moments are
updated in place (a training step then holds one copy of each) and the
same tensors are returned. ``decay`` names the tensors to decay; it
defaults to rank >= 2, and the trainer passes the rank of the JAX leaf
(a stacked layer's parameter has one more: its ``count`` axis).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..models.sharding import ShardCtx, all_reduce

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32
    warmup: int = 100


class AdamWState(NamedTuple):
    step: int                       # updates taken
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(params: Mapping[str, torch.Tensor],
               cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=cfg.state_dtype,
                               device=p.device) for n, p in params.items()}
    return AdamWState(step=0, m=zeros(), v=zeros())


def global_norm(tensors: Mapping[str, torch.Tensor],
                shards: Optional[Mapping[str, Any]] = None,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32; a 0-dim tensor
    on the tensors' device (no host synchronisation). Under a mesh, with
    each tensor's ``shards`` entry (its ``Split`` or None), the norm of the
    logical tensors: the squares of the split ones summed over their axes,
    each replicated one counted once."""
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for n, t in tensors.items():
        s = t.float().square().sum()
        split = None if shards is None else shards[n]
        axes = () if split is None else split.axes
        sums[axes] = s if axes not in sums else sums[axes] + s
    total = sums.pop((), None)
    for axes, s in sums.items():        # the same order on every rank
        s = all_reduce(s, ctx, axes)
        total = s if total is None else total + s
    return total.sqrt()


def _schedule(cfg: AdamWConfig, step: int) -> float:
    return cfg.lr * min(1.0, (step + 1) / max(cfg.warmup, 1))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor],
                 cfg: AdamWConfig = AdamWConfig(),
                 decay: Optional[Mapping[str, bool]] = None,
                 shards: Optional[Mapping[str, Any]] = None,
                 ctx: Optional[ShardCtx] = None
                 ) -> Tuple[Mapping[str, torch.Tensor], AdamWState,
                            torch.Tensor]:
    """Returns (params, new_state, pre-clip grad norm); ``params`` and the
    moments are updated in place. Under a mesh each rank updates its shards
    with the logical gradient's norm (``global_norm`` with ``shards``)."""
    gnorm = global_norm(grads, shards, ctx)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    # the bias corrections in float32, as JAX's b ** step.astype(float32)
    f32 = dict(dtype=torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, **f32) ** torch.tensor(step, **f32)
    b2c = 1.0 - torch.tensor(cfg.b2, **f32) ** torch.tensor(step, **f32)
    for name, p in params.items():
        g32 = grads[name].float() * scale
        m32 = cfg.b1 * state.m[name].float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * state.v[name].float() + (1 - cfg.b2) * g32 * g32
        delta = (m32 / b1c.to(p.device)) / (
            torch.sqrt(v32 / b2c.to(p.device)) + cfg.eps)
        if cfg.weight_decay and (p.dim() >= 2 if decay is None
                                 else decay[name]):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        state.m[name].copy_(m32)
        state.v[name].copy_(v32)
    return params, AdamWState(step, state.m, state.v), gnorm
