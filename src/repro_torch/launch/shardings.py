"""Where each parameter lives on the mesh (``repro.launch.shardings``'s
counterpart), and moving state between logical arrays and a rank's
shards.

Placement is derived from the parameter's name and logical shape, as the
JAX package derives its partition specs from the tree path:
  * TP: the output dim of the projections in ``_OUT_TP`` (heads, d_ff,
    the untied vocab) and the input dim of the out-projections in
    ``_IN_TP`` over "model"; the tied embedding's vocab rows too;
  * EP: an expert bank's expert dim over ``ctx.ep_axes``;
  * everything else (norm gains, the router, SSM and RG-LRU mixers, which
    run only where "model" has one rank) replicated;
  * a dim the axes do not divide stays replicated (``ShardCtx.split``, the
    JAX package's ``_guarded``).
One difference: a GQA/MQA model's ``wk``/``wv`` stay replicated, since its
KV heads are (``blocks.AttnDims``); the JAX package shards the weight and
gathers it at use. A rank whose query heads read only some of those KV
heads has a partial gradient for them, summed over "model"
(``grad_sum_axes``), as is the router's when the experts are sharded.

``Model`` builds each parameter at its shard's shape with its ``Split`` as
the parameter's ``shard`` (``models.lm.Model``); ``shard_state`` and
``gather_state`` take those (``model_splits``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..models.sharding import (ShardCtx, Split, all_gather, gather_to_first,
                               shard_tensor)

__all__ = ["param_placement", "grad_sum_axes", "model_splits",
           "shard_state", "gather_state", "gather_to_root", "shard_batch"]

#: weight-dict parents whose 'w' has its OUTPUT dim split over "model"
_OUT_TP = {"wq", "wk", "wv", "wi", "wg", "unembed"}
#: parents whose 'w' has its INPUT dim split over "model"
_IN_TP = {"wo"}
#: expert banks ([E, d, F] / [E, F, d]), dim 0 = expert
_EXPERT = {"w_in", "w_gate", "w_out"}
#: projections whose KV heads stay replicated unless the model is MHA
_KV = {"wk", "wv"}


def _kv_sharded(cfg) -> bool:
    """MHA models split their KV heads with the query heads; GQA and MQA
    keep them whole (the JAX ``AttnDims.kv_sharded``)."""
    return cfg.n_kv == cfg.n_heads


def param_placement(name: str, shape: Tuple[int, ...], cfg,
                    ctx: ShardCtx) -> Optional[Split]:
    """The rank's ``Split`` of the parameter ``name`` (the port's name,
    e.g. ``seg0.3.0.mix.wq.w``) of logical ``shape``, or None."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    mdl = ctx.model_axis
    if leaf == "embed":
        return ctx.split(0, mdl, shape[0])
    if leaf in _EXPERT and len(shape) == 3:
        return ctx.split(0, ctx.ep_axes, shape[0])
    if parent in _KV and not _kv_sharded(cfg):
        return None
    if leaf == "w" and parent in _OUT_TP:
        return ctx.split(1, mdl, shape[1])
    if leaf == "w" and parent in _IN_TP:
        return ctx.split(0, mdl, shape[0])
    if leaf == "b" and parent in _OUT_TP:
        return ctx.split(0, mdl, shape[0])
    return None


def grad_sum_axes(name: str, split: Optional[Split], cfg,
                  ctx: ShardCtx) -> Tuple[str, ...]:
    """The mesh axes over which a rank's gradient of ``name`` is summed
    after the backward: the data axes (every rank holds its rows of the
    batch) unless the parameter is split over them, and "model" for a
    replicated parameter that only the rank's share of the work reaches
    (GQA ``wk``/``wv`` under TP, the router under EP)."""
    own = set(split.axes) if split is not None else set()
    axes = [a for a in ctx.batch_axes if a not in own]
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    partial = ((parent in _KV and not _kv_sharded(cfg)) or
               (leaf == "router" and ctx.ep_size > 1
                and cfg.n_experts % ctx.ep_size == 0))
    if partial and ctx.model_axis not in own:
        axes.append(ctx.model_axis)
    mesh_order = ("data", "model")
    return tuple(a for a in mesh_order if a in axes and ctx.size(a) > 1)


def model_splits(model) -> Dict[str, Optional[Split]]:
    """Each parameter's ``Split`` (None where whole), by name."""
    return {n: getattr(p, "shard", None) for n, p in model.named_parameters()}


def shard_state(logical: Mapping[str, torch.Tensor],
                shards: Mapping[str, Optional[Split]]
                ) -> Dict[str, torch.Tensor]:
    """The rank's blocks of logical tensors named as the parameters whose
    ``shards`` (``model_splits``) are given: parameters, gradients,
    optimizer moments."""
    return {n: shard_tensor(t, shards[n]) for n, t in logical.items()}


def gather_state(tensors: Mapping[str, torch.Tensor],
                 shards: Mapping[str, Optional[Split]],
                 ctx: ShardCtx) -> Dict[str, torch.Tensor]:
    """The logical tensors, on the host, rebuilt from every rank's blocks
    (named as the parameters whose ``shards`` are given): copies, never
    views of the tensors given. A collective: every rank of the mesh calls
    it, in the same order."""
    out = {}
    for n, t in tensors.items():
        s = shards[n]
        t = t.detach()
        out[n] = (t if s is None else all_gather(t, ctx, s.axes, s.dim)
                  ).to("cpu", copy=True)
    return out


def gather_to_root(t: torch.Tensor, split: Optional[Split], ctx: ShardCtx
                   ) -> Optional[torch.Tensor]:
    """The logical tensor of the rank's block ``t`` (its ``split``) as a
    host copy on rank 0, None on every other rank. Only rank 0's group over
    the split's axes moves data, a ``gather`` to rank 0; every other rank
    holds a copy of one of those blocks and sends nothing. Every rank calls
    it, in the same order."""
    mesh = ctx.mesh
    if split is not None and not any(
            mesh.coord(a) for a in mesh.names if a not in split.axes):
        t = gather_to_first(t, ctx, split.axes, split.dim)
    elif mesh.rank != 0:
        t = None
    return None if t is None else t.detach().to("cpu", copy=True)


def shard_batch(batch: Mapping[str, torch.Tensor], ctx: Optional[ShardCtx]
                ) -> Dict[str, torch.Tensor]:
    """The rank's rows of a global batch over the data axes; a batch whose
    rows the data axes do not divide stays whole on every rank (the loss's
    global mean and the summed gradients are the same either way)."""
    if ctx is None or ctx.data_size == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        s = ctx.split(0, ctx.batch_axes, v.shape[0])
        out[k] = shard_tensor(v, s)
    return out
