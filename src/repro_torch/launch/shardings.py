"""Where each parameter lives on the mesh (``repro.launch.shardings``'s
counterpart), and moving state between logical arrays and a rank's
shards.

Placement is derived from the parameter's name and logical shape, as the
JAX package's ``param_pspec`` derives its partition specs from the tree
path; a parameter gets up to two ``Split``s, its TP or EP ``shard`` and,
under ``ShardCtx.zero3``, its ``z3`` split of another dim:
  * TP: the output dim of the projections in ``_OUT_TP`` (heads, MLA's
    up-projections, d_ff, the untied vocab, RG-LRU's branches) and the
    input dim of the out-projections in ``_IN_TP`` over "model", the
    embedding's vocab rows, RG-LRU's gates and decay by channel blocks;
  * EP: an expert bank's expert dim over ``ctx.ep_axes``;
  * ZeRO-3: the other dim of every ``w`` over ``zero3_axes`` (the input
    dim, but the output dim of the out-projections and of the SSM mixer's
    ``w_out``; the embedding's width), an expert bank's d (its dim 1) over
    the zero3 axes that do not carry experts; norms, the router, conv
    taps, biases, gates and the SSM's per-head vectors get none;
  * everything else (MLA's ``wq_a``/``wkv_a`` and ``mtp_proj``, JAX's
    ``_REPL``, and the SSM mixer, which runs whole on every rank of
    "model") is whole over "model";
  * a dim the axes do not divide stays whole (``ShardCtx.split``, the JAX
    package's ``_guarded``).
Two differences from the JAX package, both documented (ROADMAP queue 3):
  * a GQA/MQA model's ``wk``/``wv`` stay whole over "model", since its KV
    heads are (``blocks.AttnDims``; under ZeRO-3 they are split over the
    zero3 axes by their input dim); the JAX package shards the weight over
    "model" and gathers it at use;
  * an RG-LRU block's decode caches (``conv`` [B, W-1, w], ``state``
    [B, w]) hold the rank's channels, as its parameters do; JAX's
    ``cache_pspec`` keeps state leaves whole over "model", which would
    cost the port an all-gather a decode step for the same logical values.
A rank whose query heads read only some of those KV heads has a partial
gradient for them, summed over "model" (``grad_sum_axes``), as is the
router's when the experts are sharded, that of MLA's whole projections
and norms (``_MLA_WHOLE``) under TP and that of an RG-LRU block's conv
taps, whole over "model", of which a rank reads its columns.

``Model`` builds each parameter at its shard's shape with its ``Split`` as
the parameter's ``shard`` (``models.lm.Model``); ``shard_state`` and
``gather_state`` take those (``model_splits``).

Decode caches (JAX's ``cache_pspec``): with ``ShardCtx.kv_seq_shard`` a
token leaf (``k``, ``v``, ``c``, ``kr``, and the cross K/V ``xk``, ``xv``:
``[count, B, S, ...]``) holds the rank's block of the slots and every real
KV head. ``decode_cache`` is the Stage-3 hand-over of a rank's prefill
caches to its decode cache (each rank keeps only its slots);
``gather_cache`` joins the ranks' caches into the logical one (every
slot, every RG-LRU channel).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..models.lm import plan_segments
from ..models.sharding import (ShardCtx, Split, Splits, all_gather,
                               gather_to_first, shard_tensor, slot_block,
                               splits_of)
from ..serving.engine import admit_leaf
from ..serving.paged_kv import is_token_leaf_path, tree_map_with_path

__all__ = ["param_placement", "grad_sum_axes", "model_splits",
           "shard_state", "gather_state", "gather_to_root", "shard_batch",
           "gather_cache", "join_kv_heads", "decode_cache"]

#: weight-dict parents whose 'w' has its OUTPUT dim split over "model"
_OUT_TP = {"wq", "wk", "wv", "wq_b", "wk_b", "wv_b", "wi", "wg", "unembed",
           "w_x", "w_gate_branch"}
#: parents whose 'w' has its INPUT dim split over "model"
_IN_TP = {"wo", "w_out_rg"}
#: RG-LRU's block-diagonal gates and per-channel decay: dim 0 over "model"
_CHANNEL_TP = {"gate_in", "gate_rec", "a_param"}
#: expert banks ([E, d, F] / [E, F, d]), dim 0 = expert
_EXPERT = {"w_in", "w_gate", "w_out"}
#: projections whose KV heads stay replicated unless the model is MHA
_KV = {"wk", "wv"}
#: MLA's replicated projections and norms, which feed every head: a rank's
#: heads give a partial gradient of them under TP
_MLA_WHOLE = {"wq_a", "q_norm", "wkv_a", "kv_norm"}
#: an RG-LRU block's leaves whole over "model" of which a rank reads its
#: channels' columns: a partial gradient under TP
_RGLRU_WHOLE = {"conv"}
#: the cross K/V's cache leaves, indexed by source position
_CROSS = ("xk", "xv")


def _kv_sharded(cfg) -> bool:
    """MHA models split their KV heads with the query heads; GQA and MQA
    keep them whole (the JAX ``AttnDims.kv_sharded``)."""
    return cfg.n_kv == cfg.n_heads


Placement = Tuple[Optional[Split], Optional[Split]]


def param_placement(name: str, shape: Tuple[int, ...], cfg,
                    ctx: ShardCtx) -> Placement:
    """The rank's (TP or EP ``Split``, ZeRO-3 ``Split``) of the parameter
    ``name`` (the port's name, e.g. ``seg0.3.0.mix.wq.w``) of logical
    ``shape``, each None where that split does not apply."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")

    def tp(dim):
        return ctx.split(dim, ctx.model_axis, shape[dim])

    def z3(dim, axes=None):
        axes = ctx.zero3_axes if axes is None else axes
        return ctx.split(dim, axes, shape[dim]) if ctx.zero3 and axes \
            else None

    if leaf == "embed":
        return tp(0), z3(1)
    if leaf in _EXPERT and len(shape) == 3:
        spare = tuple(a for a in ctx.zero3_axes if a not in ctx.ep_axes)
        return ctx.split(0, ctx.ep_axes, shape[0]), z3(1, spare)
    if leaf in _CHANNEL_TP:
        return tp(0), None
    whole_kv = parent in _KV and not _kv_sharded(cfg)
    if leaf == "b":
        return (tp(0) if parent in _OUT_TP and not whole_kv else None), None
    if leaf != "w":
        return None, None
    if whole_kv:
        return None, z3(0)
    if parent in _OUT_TP:
        return tp(1), z3(0)
    if parent in _IN_TP:
        return tp(0), z3(1)
    return None, z3(1 if parent == "w_out" else 0)


def grad_sum_axes(name: str, split: Splits, cfg,
                  ctx: ShardCtx) -> Tuple[str, ...]:
    """The mesh axes, in the mesh's order, over which a rank's gradient of
    ``name`` (its ``split``s, ``model_splits``) is summed after the
    backward: the data axes (every rank holds its rows of the batch) but
    those it is split over (a ZeRO-3 gradient arrives reduce-scattered
    over them, ``sharding.gather_param``), and "model" for a parameter
    whole there that only the rank's share of the work reaches (GQA
    ``wk``/``wv``, MLA's ``_MLA_WHOLE`` and an RG-LRU block's conv taps
    under TP, the router under EP). The conv taps are told from the SSM
    mixer's, which every rank reads whole, by their layer's kind."""
    if ctx.mesh is None:
        return ()
    own = {a for s in splits_of(split) for a in s.axes}
    axes = [a for a in ctx.batch_axes if a not in own]
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    partial = ((parent in _KV and not _kv_sharded(cfg)) or
               parent in _MLA_WHOLE or
               (leaf in _RGLRU_WHOLE and _layer_kind(name, cfg) == "rec") or
               (leaf == "router" and ctx.ep_size > 1
                and cfg.n_experts % ctx.ep_size == 0))
    if partial and ctx.model_axis not in own:
        axes.append(ctx.model_axis)
    return tuple(a for a in ctx.mesh.names if a in axes and ctx.size(a) > 1)


def _layer_kind(name: str, cfg) -> Optional[str]:
    """The mixer kind of the decoder layer that owns the parameter ``name``
    (``seg{si}.{block}.{sublayer}...``, ``models.lm.plan_segments``); None
    for any other parameter."""
    parts = name.split(".")
    if not parts[0].startswith("seg") or len(parts) < 3:
        return None
    return plan_segments(cfg)[int(parts[0][3:])].kinds[int(parts[2])][0]


def model_splits(model) -> Dict[str, Tuple[Split, ...]]:
    """Each parameter's ``Split``s (``sharding.splits_of``: none where
    whole), by name."""
    return {n: splits_of(p) for n, p in model.named_parameters()}


def shard_state(logical: Mapping[str, torch.Tensor],
                shards: Mapping[str, Splits]
                ) -> Dict[str, torch.Tensor]:
    """The rank's blocks of logical tensors named as the parameters whose
    ``shards`` (``model_splits``) are given: parameters, gradients,
    optimizer moments."""
    return {n: shard_tensor(t, shards[n]) for n, t in logical.items()}


def gather_state(tensors: Mapping[str, torch.Tensor],
                 shards: Mapping[str, Splits],
                 ctx: ShardCtx) -> Dict[str, torch.Tensor]:
    """The logical tensors, on the host, rebuilt from every rank's blocks
    (named as the parameters whose ``shards`` are given): copies, never
    views of the tensors given. A collective: every rank of the mesh calls
    it, in the same order."""
    out = {}
    for n, t in tensors.items():
        t = t.detach()
        for s in splits_of(shards[n]):
            t = all_gather(t, ctx, s.axes, s.dim)
        out[n] = t.to("cpu", copy=True)
    return out


def gather_to_root(t: torch.Tensor, split: Splits, ctx: ShardCtx
                   ) -> Optional[torch.Tensor]:
    """The logical tensor of the rank's block ``t`` (its ``split``s) as a
    host copy on rank 0, None on every other rank. Only the ranks whose
    coordinates off the splits' axes are 0 move data: a ``gather`` to the
    first rank of each group over the last split's axes, then over the
    one before among those first ranks, which ends on rank 0; every other
    rank holds a copy of one of those blocks and sends nothing. Every rank
    calls it, in the same order."""
    mesh = ctx.mesh
    splits = splits_of(split)
    own = {a for s in splits for a in s.axes}
    if any(mesh.coord(a) for a in mesh.names if a not in own):
        return None
    for i in reversed(range(len(splits))):
        s = splits[i]
        later = {a for s2 in splits[i + 1:] for a in s2.axes}
        if any(mesh.coord(a) for a in later):
            break                        # sent its block to a first rank
        t = gather_to_first(t, ctx, s.axes, s.dim)
    return None if mesh.rank != 0 else t.detach().to("cpu", copy=True)


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


def _map_cache(fn, caches, model):
    """``fn(name, leaf, kind)`` over the leaves of ``model``'s caches (a
    list per segment, a list per sublayer, ``{"mix": {...}}`` entries with
    the cross K/V beside), ``kind`` the mixer kind of the leaf's layer
    (``Segment.kinds``)."""
    return [[{k: ({n: fn(n, t, kind) for n, t in e.items()}
                  if isinstance(e, dict) else fn(k, e, kind))
              for k, e in entry.items()}
             for (kind, _, _), entry in zip(seg.kinds, entries)]
            for seg, entries in zip(model.segments, caches)]


def _slotted(name: str) -> bool:
    """A leaf split over "model" by its slots under ``kv_seq_shard``: a
    token leaf (``serving.paged_kv.is_token_leaf_path``) or the cross
    K/V, over the source positions."""
    return is_token_leaf_path((name,)) or name in _CROSS


def gather_cache(local, model):
    """The logical decode cache of every rank's blocks of ``model``'s
    caches: the slotted leaves joined over "model" along their slots under
    ``kv_seq_shard``, an RG-LRU block's leaves along their channels (a
    collective: every rank calls it, in the same order)."""
    ctx = model.ctx

    def leaf(name, t, kind):
        if _slotted(name) and ctx.seq_sharded:
            return all_gather(t, ctx, ctx.model_axis, 2)
        if kind == "rec":
            return all_gather(t, ctx, ctx.model_axis, t.dim() - 1)
        return t
    return _map_cache(leaf, local, model)


def join_kv_heads(caches, model):
    """A prefill's caches with every real KV head, as a sequence-sharded
    decode cache stores them: a model whose KV heads are split over "model"
    (MHA under TP) has its blocks of self- and cross-attention K/V
    gathered (a collective), and a padded MHA model's padded heads are
    cropped."""
    ctx, n_kv = model.ctx, model.cfg.n_kv

    def leaf(name, t, kind):
        if name not in ("k", "v") + _CROSS:
            return t
        if model.kv_split:
            t = all_gather(t, ctx, ctx.model_axis, 3)
        return t[:, :, :, :n_kv]
    return _map_cache(leaf, caches, model)


def decode_cache(caches, model, n_tokens: int, capacity: int):
    """A rank's prefill caches of ``n_tokens`` positions (its rows of one
    prompt length) handed over as its part of a decode cache of
    ``capacity`` slots (``DecodeBatch.add``'s admission, a rank's share):
      1. under ``kv_seq_shard``, every real KV head (``join_kv_heads``;
         without it the rank decodes over its own heads);
      2. each token leaf of a layer's ``"mix"`` as ``serving.engine.
         admit_leaf`` holds it: a local layer's window-cropped prefill
         rolled into its ring's order, grown to its slots;
      3. under ``kv_seq_shard``, each slotted leaf (the cross K/V's over
         the source positions among them) cut to the rank's
         ``slot_block``: a copy, so the prefill's caches can be freed.
    State leaves stay as the prefill left them: an SSM's whole, an RG-LRU
    block's the rank's channels. Raises where a leaf holds more positions
    than its slots, or the model axis does not divide them."""
    ctx = model.ctx
    if ctx.seq_sharded:
        caches = join_kv_heads(caches, model)
    caches = tree_map_with_path(
        lambda path, t: admit_leaf(model, path, t, n_tokens, capacity),
        caches)
    if not ctx.seq_sharded:
        return caches

    def slots(name, t, kind):
        if not _slotted(name):
            return t
        lo, n = slot_block(ctx, t.shape[2])
        return t[:, :, lo:lo + n].clone()
    return _map_cache(slots, caches, model)
