"""Decoder blocks: GQA attention (full or local), cross-attention over an
encoder's memory, multi-head latent attention (MLA, DeepSeek-V3), the
SwiGLU FFN, the mixture-of-experts FFN (routed and shared experts), the
Mamba2 (SSD) mixer and the RG-LRU recurrent block of RecurrentGemma.

``attn_apply`` has the JAX package's serving modes:
  * ``prefill`` — full-sequence causal; with ``cache`` a *suffix* prefill
    over a reused prefix (the query starts at ``q_offset = Pk``);
  * ``decode``  — one token per sequence against a fixed-capacity cache,
    each sequence at its own position (``pos`` is a [B] tensor): the new
    K/V are written in place at each sequence's position and attention
    runs with ``lengths = pos + 1``;
  * ``encode``  — full-sequence bidirectional, no cache (an encoder);
  * ``train``   — the prefill's math with no cache built or returned (the
    JAX package's train mode); every block has it, and no block writes in
    place on it, so autograd runs through (the attention kernel's backward
    through ``FlashAttentionFn``).
``mla_apply`` has the prefill and decode modes over a latent cache
``{"c", "kr"}`` (see its docstring); ``cross_apply`` attends to an
encoder's memory, or to the cross K/V a cache holds.
A local-attention layer (``window > 0``) masks keys ``window`` or more
positions back, keeps only the last ``window`` positions in its prefill
cache and decodes into a ring buffer (see ``attn_apply``). A decode cache
may hold K/V as int8 codes (``Model.init_cache(kv_dtype=torch.int8)``):
decode stores the new token through ``_kv_store`` and the decode kernel
reads the codes; a suffix prefill refuses such a cache (see ``_kv_load``).
``ssd_apply`` and ``rglru_apply`` have
the same three modes over a per-sequence ``{"conv", "state"}`` cache (see
``ssd_apply``'s docstring). ``moe_apply`` has the JAX package's three
MoE branches: on one device tokens sorted by expert through grouped
products for a prefill, each token through its experts' gathered weights
for decode; under expert parallelism the dispatch and combine over
``all_to_all`` (``_moe_dispatch``) or the replicated tokens' partial sums
(``_moe_replicated``).

Under tensor parallelism (``models.sharding``, a rank's shard of each
parameter) attention, cross-attention and MLA run the rank's block of the
query heads with ``wo`` row-parallel, the SwiGLU its block of ``d_ff`` and
RG-LRU its block of the channels (``w_out_rg`` row-parallel). With
``ShardCtx.kv_seq_shard`` a decode cache is sequence-sharded over the
model axis (``_seq_write``, ``_seq_merge``): each rank holds every real KV
head (MLA: the latent) over its block of slots (a local layer's: of its
ring; cross-attention's: of the source positions), attends with every
query head over them and merges its own heads' partials with the other
ranks'.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from ..kernels.attn_split import attn_merge
from ..kernels.decode_attention import kv_dequant, partial_softmax
from .layers import (Dense, RMSNorm, SwiGLU, apply_rope, logical_shape,
                     normal_, rmsnorm, rope)
from .sharding import (HEAD_PAD, ShardCtx, all_gather, all_to_all, copy_to,
                       exchange, gather_from, gather_partial, pad_to_multiple,
                       reduce_from, scatter_to, shard_tensor, slot_block)

__all__ = ["AttnDims", "Attention", "attn_init", "attn_apply", "cross_apply",
           "MLA", "mla_init", "mla_apply", "ffn_init", "ffn_apply", "MoE",
           "moe_init", "moe_apply", "SSD", "ssd_init", "ssd_apply", "RGLRU",
           "rglru_init", "rglru_apply", "rglru_blocks"]


# ------------------------------------------------------------- int8 KV cache
_KV_QSCALE = 32.0       # static symmetric scale: codes of 1/32, range ~ +/-4


def _kv_store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a cache of ``dtype`` holds it: for int8 the JAX model's
    codes, ``clamp(round(x * 32), -127, 127)`` in float32 (``torch.round``
    rounds half to even, as ``jnp.round``)."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * _KV_QSCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def _kv_load(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of a cache leaf in ``dtype``: int8 codes times 1/32
    (``kv_dequant``, the one dequantisation, which the decode kernel's plain
    version calls), anything else as it is. Decode does not call it: the
    decode kernel reads the codes and their scale. A suffix prefill refuses
    an int8 cache; the JAX model concatenates its codes with the new keys
    unscaled, reading each code as a value."""
    if x.dtype == torch.int8:
        return kv_dequant(x, 1.0 / _KV_QSCALE, dtype)
    return x


@dataclass(frozen=True)
class AttnDims:
    """Padded head layout (logical, over every rank): query heads pad to a
    multiple of ``HEAD_PAD`` (``ShardCtx.head_multiple``; the padded heads
    are exact no-ops through zeroed ``wo`` rows). KV heads keep their true
    count unless the model is MHA, where they pad alongside the query heads
    and are split over the model axis with them; a GQA/MQA model's stay
    whole on every rank."""

    n_q: int           # padded query heads
    n_kv: int          # stored kv heads (== n_q when MHA)
    hd: int

    @staticmethod
    def of(cfg: ArchConfig, ctx: Optional[ShardCtx] = None) -> "AttnDims":
        n_q = pad_to_multiple(cfg.n_heads, HEAD_PAD if ctx is None
                              else ctx.head_multiple)
        if cfg.n_kv == cfg.n_heads:
            return AttnDims(n_q, n_q, cfg.hd)
        return AttnDims(n_q, cfg.n_kv, cfg.hd)

    def q_to_kv(self, cfg: ArchConfig) -> torch.Tensor:
        """Static map: padded query head -> kv head, ``min(h // rep,
        n_kv - 1)``. Not uniform once heads are padded (full smollm: 15
        heads in groups of 3 over 5 kv heads, padded head 15 -> kv 4)."""
        rep = max(1, cfg.n_heads // cfg.n_kv)
        return torch.tensor([min(h // rep, self.n_kv - 1)
                             for h in range(self.n_q)], dtype=torch.long)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        dims = AttnDims.of(cfg)
        d, b = cfg.d_model, cfg.qkv_bias
        self.wq = Dense(d, dims.n_q * dims.hd, bias=b, dtype=dtype,
                        device=device)
        self.wk = Dense(d, dims.n_kv * dims.hd, bias=b, dtype=dtype,
                        device=device)
        self.wv = Dense(d, dims.n_kv * dims.hd, bias=b, dtype=dtype,
                        device=device)
        self.wo = Dense(dims.n_q * dims.hd, d, dtype=dtype, device=device)
        self.real_rows = cfg.n_heads * dims.hd
        self.n_heads = cfg.n_heads
        self.tp: Optional[ShardCtx] = None     # set by localize under TP
        # the q->kv map the attention kernels read, int32 on the model's
        # device: made once, never converted or copied per call; the same
        # map as Python ints, from which the backward kernel's inverse map
        # is built on the host
        q_to_kv = dims.q_to_kv(cfg)
        self.register_buffer("kv_map", q_to_kv.to(
            device=device, dtype=torch.int32), persistent=False)
        self.kv_map_host = tuple(q_to_kv.tolist())

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.init(generator)
        # zero the padded query heads' output rows => exact no-op heads
        # (the rows of a rank's shard from its offset in the whole)
        split = getattr(self.wo.w, "shard", None)
        lo = 0 if split is None else split.index * self.wo.w.shape[0]
        self.wo.w[max(0, self.real_rows - lo):] = 0.0

    def localize(self, ctx: ShardCtx) -> None:
        """After the parameters took their shards (``Model``): the rank's
        query heads are a block of the padded heads, and its q->kv map the
        same block of the map, into its own block of KV heads where those
        are split (MHA) or into every KV head where they are whole. The
        whole map stays as ``kv_map_all``: a sequence-sharded decode
        attends with every query head."""
        split = getattr(self.wq.w, "shard", None)
        host = self.kv_map_host
        self.kv_map_all = torch.tensor(host, dtype=torch.int32,
                                       device=self.wq.w.device)
        if split is None and ctx.model_size > 1:
            raise ValueError(f"{ctx.model_size} ranks on the model axis do "
                             f"not divide the {self.wq.w.shape[1]} query "
                             "columns")
        if split is not None:
            hd = self.real_rows // self.n_heads
            nq = self.wq.w.shape[1] // hd
            if nq * hd != self.wq.w.shape[1]:
                raise ValueError(f"a rank's {self.wq.w.shape[1]} query "
                                 f"columns are not whole heads of {hd}")
            host = host[split.index * nq:(split.index + 1) * nq]
            kv_split = getattr(self.wk.w, "shard", None)
            if kv_split is not None:
                nkv = self.wk.w.shape[1] // hd
                host = tuple(h - kv_split.index * nkv for h in host)
            self.tp = ctx
        self.kv_map_host = tuple(host)
        self.kv_map = torch.tensor(host, dtype=torch.int32,
                                   device=self.wq.w.device)


def attn_init(cfg: ArchConfig, *, dtype=torch.bfloat16,
              device=None) -> Attention:
    return Attention(cfg, dtype=dtype, device=device)


def _attend(p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            **kw) -> torch.Tensor:
    """The prefill attention kernel over the stored KV heads through the
    layer's map (differentiable: the backward builds its inverse map from
    ``kv_map_host``)."""
    return kops.attention(q, k, v, kv_map=p.kv_map,
                          kv_map_host=p.kv_map_host, **kw)


def attn_apply(p: Attention, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Union[int, torch.Tensor] = 0, window: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D]. Returns (y, new_cache).

    With ``window`` a query sees the keys less than ``window`` positions
    back; a prefill keeps the last ``min(window, length)`` positions, and
    decode treats the cache of ``S <= window`` slots as a ring in which
    position p lives at slot ``p % S`` (``DecodeBatch.add`` rolls a cropped
    prefill cache into that order). Every slot of the ring is valid once
    ``pos + 1 >= S`` and the first ``pos + 1`` are before, so decode
    attention runs with ``lengths = min(pos + 1, S)`` in both cases: the
    order of the keys does not matter to it.

    The kernels take the stored KV heads and the query-head -> KV-head map
    (``p.kv_map``), which they clamp to the stored heads: the JAX model's
    ``jnp.minimum(q_to_kv, n_store - 1)``, for a decode cache of a padded
    MHA model that keeps only the real heads.

    Under tensor parallelism (``p.tp``, ``Attention.localize``) the rank
    runs its block of the query heads over its KV heads (its block of an
    MHA model's, all of a GQA model's) and its cache holds those; ``wo`` is
    row-parallel, its partial products summed over the model axis. With
    ``kv_seq_shard`` decode runs ``_attn_decode_seq``."""
    B, T, _ = x.shape
    hd = AttnDims.of(cfg).hd
    n_q, n_kv = p.wq.w.shape[1] // hd, p.wk.w.shape[1] // hd   # the rank's
    if p.tp is not None:
        x = copy_to(x, p.tp, p.tp.model_axis)
    q = p.wq(x).reshape(B, T, n_q, hd)
    k = p.wk(x).reshape(B, T, n_kv, hd)
    v = p.wv(x).reshape(B, T, n_kv, hd)
    if mode == "decode":
        positions = pos.reshape(B, 1)                          # [B, 1]
    else:
        positions = pos + torch.arange(T, device=x.device)[None, :]
    sin, cos = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if mode == "decode" and p.tp is not None and p.tp.seq_sharded:
        assert cache is not None and T == 1
        out = _attn_decode_seq(p, q, k, v, cache, pos, window)
        new_cache = cache
    elif mode == "decode":
        assert cache is not None and T == 1
        ck, cv = cache["k"], cache["v"]                      # [B,S,n_store,hd]
        S, n_store = ck.shape[1], ck.shape[2]
        # written in place: a local layer at pos % S of its ring; a full
        # one at pos, a position past the capacity clamped to the last slot,
        # as JAX's dynamic_update_slice does, so dead slots stay inside
        slot = pos % S if window else pos.clamp(max=S - 1)
        rows = torch.arange(B, device=x.device)
        ck[rows, slot] = _kv_store(k[:, 0, :n_store], ck.dtype)
        cv[rows, slot] = _kv_store(v[:, 0, :n_store], cv.dtype)
        lengths = (pos + 1).clamp(max=S)
        kv_scale = 1.0 / _KV_QSCALE if ck.dtype == torch.int8 else None
        out = kops.decode_attention(q[:, 0], ck, cv, lengths,
                                    kv_map=p.kv_map,
                                    kv_scale=kv_scale)[:, None]
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        # suffix prefill over a reused prefix holding positions [pos-Pk, pos):
        # masks depend only on position differences, so q_offset = Pk
        if cache["k"].dtype == torch.int8:
            raise ValueError(
                "suffix prefill over an int8 KV cache: the prefix would "
                "join the new keys as codes, not values; int8 caches are "
                "decode caches (Model.init_cache)")
        Pk = cache["k"].shape[1]
        k_all = torch.cat([cache["k"], k], 1)
        v_all = torch.cat([cache["v"], v], 1)
        out = _attend(p, q, k_all, v_all, causal=True, q_offset=Pk,
                      window=window)
        keep = min(window, Pk + T) if window else Pk + T
        new_cache = {"k": k_all[:, -keep:], "v": v_all[:, -keep:]}
    elif mode in ("encode", "train"):
        out = _attend(p, q, k, v, causal=mode == "train", window=window)
        new_cache = None
    else:
        out = _attend(p, q, k, v, causal=True, window=window)
        keep = min(window, T) if window else T
        new_cache = {"k": k[:, T - keep:], "v": v[:, T - keep:]}
    y = p.wo(out.reshape(B, T, n_q * hd))
    if p.tp is not None:
        y = reduce_from(y, p.tp, p.tp.model_axis)
    return y, new_cache


# ------------------------------------------ sequence-sharded decode caches
def _seq_write(leaf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
               lo: int, S: int, ring: bool = False) -> None:
    """Write row b's ``new[b]`` into the rank's block ``leaf`` [B, n, ...]
    of an ``S``-slot cache at slot ``min(pos[b], S - 1)`` (a position past
    the capacity clamped to the last slot, as without the sharding), or of
    a local layer's ring (``ring``) at slot ``pos[b] % S``, where that slot
    is the rank's (``[lo, lo + n)``); other rows keep theirs. No host read:
    each row rewrites a slot of its block, with its old value where the
    slot is not its."""
    B, n = leaf.shape[0], leaf.shape[1]
    slot = (pos % S if ring else pos.clamp(max=S - 1)) - lo
    mine = ((slot >= 0) & (slot < n)).reshape(B, *([1] * (new.dim() - 1)))
    rows = torch.arange(B, device=leaf.device)
    slot = slot.clamp(0, n - 1)
    leaf[rows, slot] = torch.where(mine, new, leaf[rows, slot])


def _gather_heads(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The ranks' blocks of heads (dim 1 of ``t`` [B, h, ...]) joined over
    the model axis, the bytes sent counted in ``ctx.stats.seq_bytes``."""
    t = t.contiguous()
    ctx.stats.seq_bytes += (t.numel() * t.element_size()
                            * (ctx.model_size - 1))
    return all_gather(t, ctx, ctx.model_axis, 1)


def _seq_merge(o: torch.Tensor, lse: torch.Tensor, ctx: ShardCtx,
               dtype: torch.dtype) -> torch.Tensor:
    """The rank's partials o [B, H, D] (float32) and lse [B, H] (base 2)
    of every query head, exchanged over the model axis (one ``all_to_all``
    of ``[o, lse]``: block j of the heads to rank j), and the rank's block
    of H / m heads merged over the ranks' partials (``attn_merge``, the
    combine kernel on the card) into [B, H / m, D] of ``dtype``."""
    B, H, D = o.shape
    m = ctx.model_size
    send = torch.cat([o, lse[..., None]], -1).reshape(
        B, m, H // m, D + 1).transpose(0, 1)                # [m, B, h, D+1]
    ctx.stats.seq_bytes += _a2a_bytes(send, m)
    recv = all_to_all(send, ctx, ctx.model_axis)
    R = B * (H // m)
    out = attn_merge(recv[..., :D].reshape(m, R, D),
                     recv[..., D].reshape(m, R), dtype)
    return out.reshape(B, H // m, D)


def _attn_decode_seq(p: Attention, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: torch.Tensor, window: int) -> torch.Tensor:
    """Decode over a sequence-sharded cache (``ShardCtx.kv_seq_shard``):
    the rank holds every real KV head over its block of slots
    (``slot_block``). The new token's K/V of every real KV head (an MHA
    model's ranks gather their blocks of heads, in the one gather of q) go
    to the rank that owns the slot: ``min(pos, S - 1)``, or a local layer's
    ring slot ``pos % S`` (``attn_apply``: its slots are all valid once
    ``pos + 1 >= S`` and the first ``pos + 1`` before, so the lengths are
    the same in both cases, JAX's windowed decode under its sequence
    ``kv_spec``). The rank gathers q of every padded query head, runs the
    decode kernel's partial mode over its slots through the whole q->kv
    map (``kv_map_all``) and merges its own heads' partials with the other
    ranks' (``_seq_merge``). Returns [B, 1, h, hd] for the rank's h query
    heads, in q's dtype."""
    ctx = p.tp
    ck, cv = cache["k"], cache["v"]                    # [B, S/m, n_store, hd]
    n_store = ck.shape[2]
    S = ck.shape[1] * ctx.model_size
    lo, n = slot_block(ctx, S)
    hd = q.shape[-1]
    if getattr(p.wk.w, "shard", None) is not None:    # MHA: blocks of heads
        q1, k1, v1 = _gather_heads(torch.cat([q[:, 0], k[:, 0], v[:, 0]], -1),
                                   ctx).split(hd, -1)
    else:
        q1, k1, v1 = _gather_heads(q[:, 0], ctx), k[:, 0], v[:, 0]
    ring = bool(window)
    _seq_write(ck, _kv_store(k1[:, :n_store], ck.dtype), pos, lo, S, ring)
    _seq_write(cv, _kv_store(v1[:, :n_store], cv.dtype), pos, lo, S, ring)
    lengths = ((pos + 1).clamp(max=S) - lo).clamp(0, n)
    kv_scale = 1.0 / _KV_QSCALE if ck.dtype == torch.int8 else None
    o, lse = kops.decode_attention(q1, ck, cv, lengths, kv_map=p.kv_map_all,
                                   kv_scale=kv_scale, partial=True)
    return _seq_merge(o, lse, ctx, q.dtype)[:, None]


def cross_apply(p: Attention, x: torch.Tensor, *, cfg: ArchConfig,
                mode: str, memory: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-attention of x [B, T, D] over an encoder's ``memory`` [B, S, D],
    or over the ``xk``/``xv`` [B, S, n_kv, hd] that ``cache`` holds (used in
    its place whenever it has them, as the JAX model does): no mask, no
    rope. Returns (y, xk, xv).

    A prefill runs the flash kernel with ``causal=False`` (the function
    JAX's ``gqa_attention(mask=None)`` computes). Decode is one query per
    sequence over all S keys: the decode kernel with every length at S,
    which splits S over the SMs and reads each K/V row once per head group;
    the flash kernel at T = 1 would fill one of its 64 query rows a
    block.

    Under tensor parallelism (``p.tp``) the rank runs its block of the
    query heads over its KV heads, as ``attn_apply``: x and ``memory``
    enter through ``copy_to`` (so the decoder's and the encoder's
    gradients are summed over the model axis) and ``wo``'s partial
    products are summed. With ``kv_seq_shard`` decode runs
    ``_cross_decode_seq`` over cross K/V split by source position."""
    B, T, _ = x.shape
    hd = AttnDims.of(cfg).hd
    n_q, n_kv = p.wq.w.shape[1] // hd, p.wk.w.shape[1] // hd   # the rank's
    tp = p.tp
    if tp is not None:
        x = copy_to(x, tp, tp.model_axis)
    q = p.wq(x).reshape(B, T, n_q, hd)
    if cache is not None and "xk" in cache:
        k, v = cache["xk"], cache["xv"]
    else:
        S = memory.shape[1]
        if tp is not None:
            memory = copy_to(memory, tp, tp.model_axis)
        k = p.wk(memory).reshape(B, S, n_kv, hd)
        v = p.wv(memory).reshape(B, S, n_kv, hd)
    if mode == "decode" and tp is not None and tp.seq_sharded:
        out = _cross_decode_seq(p, q, k, v)
    elif mode == "decode":
        lengths = torch.full((B,), k.shape[1], dtype=torch.int32,
                             device=x.device)
        out = kops.decode_attention(q[:, 0], k, v, lengths,
                                    kv_map=p.kv_map)[:, None]
    else:
        out = _attend(p, q, k, v, causal=False)
    y = p.wo(out.reshape(B, T, n_q * hd))
    if tp is not None:
        y = reduce_from(y, tp, tp.model_axis)
    return y, k, v


def _cross_decode_seq(p: Attention, q: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor) -> torch.Tensor:
    """Cross-attention decode over cross K/V split by source position
    (JAX's ``cache_pspec`` token layout of ``xk``/``xv``): the rank holds
    every real KV head over its block of the source positions, all of them
    valid. It gathers q of every padded query head, runs the decode
    kernel's partial mode with every length at its block's size through
    the whole q->kv map and merges its own heads' partials with the other
    ranks' (``_seq_merge``); nothing is written. Returns [B, 1, h, hd] for
    the rank's h query heads, in q's dtype."""
    ctx = p.tp
    q1 = _gather_heads(q[:, 0], ctx)
    lengths = torch.full((xk.shape[0],), xk.shape[1], dtype=torch.int32,
                         device=xk.device)
    o, lse = kops.decode_attention(q1, xk, xv, lengths, kv_map=p.kv_map_all,
                                   partial=True)
    return _seq_merge(o, lse, ctx, q.dtype)[:, None]


# ------------------------------------------------ MLA (DeepSeek-V3 attention)
class MLA(nn.Module):
    """Multi-head latent attention, named as the JAX ``mla_init`` pytree:
    the query through a rank-``q_lora_rank`` bottleneck (``wq_a``,
    ``q_norm``, ``wq_b``: ``nope_head_dim + rope_head_dim`` a head), the
    latent ``c`` and the one shared rope key from ``wkv_a`` (``kv_norm`` on
    the latent), and the up-projections ``wk_b``, ``wv_b`` that absorbed
    attention folds into the query and the output.

    Under tensor parallelism (``localize``) ``wq_b``, ``wk_b`` and ``wv_b``
    hold the rank's block of the heads and ``wo`` its rows; ``wq_a``,
    ``q_norm``, ``wkv_a`` and ``kv_norm`` stay whole (JAX's ``_REPL``), and
    the latent cache is every rank's."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        kw = dict(dtype=dtype, device=device)
        self.wq_a = Dense(d, qr, **kw)
        self.q_norm = RMSNorm(qr, device=device)
        self.wq_b = Dense(qr, H * (dn + dr), **kw)
        self.wkv_a = Dense(d, r + dr, **kw)
        self.kv_norm = RMSNorm(r, device=device)
        self.wk_b = Dense(r, H * dn, **kw)
        self.wv_b = Dense(r, H * dv, **kw)
        self.wo = Dense(H * dv, d, **kw)
        self.tp: Optional[ShardCtx] = None     # set by localize under TP

    def init(self, generator: torch.Generator) -> None:
        for m in (self.wq_a, self.q_norm, self.wq_b, self.wkv_a,
                  self.kv_norm, self.wk_b, self.wv_b, self.wo):
            m.init(generator)

    def localize(self, ctx: ShardCtx) -> None:
        """After the parameters took their shards (``Model``): the rank
        runs its block of the heads where they are split (``lm._refuse_tp``
        has checked that the model axis divides them: JAX pads no MLA
        head)."""
        if getattr(self.wk_b.w, "shard", None) is not None:
            self.tp = ctx


def mla_init(cfg: ArchConfig, *, dtype=torch.bfloat16, device=None) -> MLA:
    return MLA(cfg, dtype=dtype, device=device)


def mla_apply(p: MLA, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              pos: Union[int, torch.Tensor] = 0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D]. Returns (y, new_cache), the cache ``{"c": [B, S,
    kv_lora_rank], "kr": [B, S, rope_head_dim]}``: the normed latent and the
    roped shared key of every position.

    Attention is absorbed, in float32 as in JAX: ``q_lat = q_nope W_kb``,
    scores ``(q_lat c + q_rope kr) / sqrt(dn + dr)``, masked to -1e30, the
    softmax, ``ctx = w c`` and ``ctx W_vb``, then ``wo``. A suffix prefill
    puts the reused latent prefix (positions ``pos - Pk`` on) before the new
    positions and builds new caches. Decode writes each sequence's latent
    and key in place at its own position ``pos[b]`` (clamped to the last
    slot, as JAX's ``dynamic_update_slice``) and masks its keys past
    ``pos[b]``; JAX decodes one sequence at a time with a scalar position.
    No Pallas kernel computes MLA: these are plain products.

    Under tensor parallelism (``p.tp``) the rank runs its block of the
    heads and ``wo``'s partial products are summed over the model axis;
    with ``kv_seq_shard`` decode runs ``_mla_decode_seq``."""
    B, T, _ = x.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    H = p.wk_b.w.shape[1] // dn                         # the rank's heads
    if p.tp is not None:
        x = copy_to(x, p.tp, p.tp.model_axis)
    q = p.wq_b(p.q_norm(p.wq_a(x))).reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = p.wkv_a(x)                                       # [B, T, r + dr]
    c_kv = p.kv_norm(kv[..., :r])                         # the latent
    k_rope = kv[..., r:]                                  # one shared head
    if mode == "decode":
        positions = pos.reshape(B, 1)
    else:
        positions = pos + torch.arange(T, device=x.device)[None, :]
    sin, cos = rope(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None], sin, cos)[:, :, 0]

    seq = mode == "decode" and p.tp is not None and p.tp.seq_sharded
    if mode == "decode":
        assert cache is not None and T == 1
        c_all, kr_all = cache["c"], cache["kr"]
        if not seq:                    # (else written by _mla_decode_seq)
            S = c_all.shape[1]
            rows = torch.arange(B, device=x.device)
            slot = pos.clamp(max=S - 1)
            c_all[rows, slot] = c_kv[:, 0].to(c_all.dtype)
            kr_all[rows, slot] = k_rope[:, 0].to(kr_all.dtype)
            k_pos = torch.arange(S, device=x.device)
            mask = k_pos[None, None, :] <= pos[:, None, None]      # [B,1,S]
    elif cache is not None:
        Pk = cache["c"].shape[1]
        c_all = torch.cat([cache["c"], c_kv], 1)
        kr_all = torch.cat([cache["kr"], k_rope], 1)
        k_pos = pos - Pk + torch.arange(Pk + T, device=x.device)
        mask = (positions[0][:, None] >= k_pos[None, :])[None]     # [1,T,S]
    else:
        c_all, kr_all = c_kv, k_rope
        mask = (positions[0][:, None] >= positions[0][None, :])[None]
    new_cache = {"c": c_all, "kr": kr_all}

    wk = p.wk_b.w.reshape(r, H, dn).float()
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), wk)  # [B,T,H,r]
    if seq:
        ctx = _mla_decode_seq(p.tp, q_lat, q_rope, c_kv, k_rope, cache, pos,
                              dn + dr)
    else:
        c32 = c_all.float()
        logits = (torch.einsum("bthr,bsr->bhts", q_lat, c32)
                  + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                                 kr_all.float())) / math.sqrt(dn + dr)
        logits = torch.where(mask[:, None], logits,
                             torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhts,bsr->bthr", w, c32)
    out = torch.einsum("bthr,rhv->bthv", ctx,
                       p.wv_b.w.reshape(r, H, dv).float())
    y = p.wo(out.to(x.dtype).reshape(B, T, H * dv))
    if p.tp is not None:
        y = reduce_from(y, p.tp, p.tp.model_axis)
    return y, None if mode == "train" else new_cache


def _mla_decode_seq(ctx: ShardCtx, q_lat: torch.Tensor, q_rope: torch.Tensor,
                    c_kv: torch.Tensor, k_rope: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                    qk_dim: int) -> torch.Tensor:
    """MLA decode over a sequence-sharded latent cache (JAX's
    ``("batch", "model", None)`` layout): the rank holds ``c``/``kr`` over
    its block of slots and writes the new latent and key where the slot
    ``min(pos[b], S - 1)`` is its (``_seq_write``); it gathers ``q_lat``
    and ``q_rope`` of every head, scores its slots in float32 (a key at
    position ``k`` seen where ``k <= pos[b]``), keeps each head's latent
    accumulator normalised over its slots with the base-2 log-sum-exp
    (``partial_softmax``), and merges its own heads' over the ranks
    (``_seq_merge``, float32). Returns the rank's heads' attention output
    in the latent, [B, 1, h, r] float32; the products are plain."""
    c_all, kr_all = cache["c"], cache["kr"]                 # [B, S/m, .]
    S = c_all.shape[1] * ctx.model_size
    lo, n = slot_block(ctx, S)
    _seq_write(c_all, c_kv[:, 0].to(c_all.dtype), pos, lo, S)
    _seq_write(kr_all, k_rope[:, 0].to(kr_all.dtype), pos, lo, S)
    ql, qr = _gather_heads(torch.cat([q_lat[:, 0], q_rope[:, 0].float()], -1),
                           ctx).split([q_lat.shape[-1], q_rope.shape[-1]], -1)
    c32 = c_all.float()
    s = (torch.einsum("bhr,bsr->bhs", ql, c32)
         + torch.einsum("bhr,bsr->bhs", qr, kr_all.float())
         ) / math.sqrt(qk_dim)
    k_pos = lo + torch.arange(n, device=c_all.device)
    w, lse = partial_softmax(s, k_pos[None, None, :] <= pos[:, None, None])
    o = torch.einsum("bhs,bsr->bhr", w, c32)
    return _seq_merge(o, lse, ctx, torch.float32)[:, None]


# ---------------------------------------------------------------- dense FFN
def ffn_init(cfg: ArchConfig, d_ff: Optional[int] = None, *,
             dtype=torch.bfloat16, device=None) -> SwiGLU:
    return SwiGLU(cfg.d_model, d_ff or cfg.d_ff, dtype=dtype, device=device)


def ffn_apply(p: SwiGLU, x: torch.Tensor,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The SwiGLU; column- then row-parallel over the model axis of ``ctx``
    where its width is split (``SwiGLU.forward``)."""
    return p(x, ctx)


# ------------------------------------------------------------------ MoE FFN
class MoE(nn.Module):
    """Routed experts and the shared ones, named as the JAX ``moe_init``
    pytree: ``router`` [d, E] (float32 in any model dtype), ``w_in`` and
    ``w_gate`` [E, d, F], ``w_out`` [E, F, d] and, with ``n_shared``, a
    ``shared`` SwiGLU of width ``n_shared * F``."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_expert or cfg.d_ff

        def param(shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.router = param((d, E), torch.float32)
        self.w_in = param((E, d, F_))
        self.w_gate = param((E, d, F_))
        self.w_out = param((E, F_, d))
        self.shared = (SwiGLU(d, cfg.n_shared * F_, dtype=dtype,
                              device=device) if cfg.n_shared else None)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 1/d) router and expert inputs, N(0, 1/F)
        expert outputs, the shared SwiGLU as a dense one (d read off the
        logical shape: ZeRO-3 splits it)."""
        _, d, F_ = logical_shape(self.w_in)
        for w in (self.router, self.w_in, self.w_gate):
            normal_(w, generator, d ** -0.5)
        normal_(self.w_out, generator, F_ ** -0.5)
        if self.shared is not None:
            self.shared.init(generator)


def moe_init(cfg: ArchConfig, *, dtype=torch.bfloat16, device=None) -> MoE:
    return MoE(cfg, dtype=dtype, device=device)


def _route(x_flat: torch.Tensor, router: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over the experts in float32, the ``top_k`` largest, gates
    renormalised to sum to one. Returns (gates [N, K] float32, idx [N, K])."""
    probs = torch.softmax(x_flat.float() @ router, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), idx


def _host_count(t: torch.Tensor, on_meta: int) -> int:
    """``int(t)``: a count read on the host. A meta tensor (the dry run,
    ``launch.dryrun``) holds no value: ``on_meta`` stands for it."""
    return on_meta if t.device.type == "meta" else int(t)


def _expert_ffn(w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor,
                x: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert, the function of JAX's
    ``ragged_dot``: row ``r`` of ``x`` goes through expert ``expert[r]``
    (non-decreasing). Each group is laid at the front of its expert's slot
    of an ``[E, C, d]`` buffer, C the largest group, and the three products
    run batched over the experts, each expert's weights read once; the zero
    rows past a group are never read back.

    C is read on the host, one synchronisation a call: the buffer is sized
    by it (on the meta device, the balanced group ``ceil(rows / E)``). The group offsets come from a search over the sorted ids (JAX's
    ``bincount`` group sizes, as offsets), which needs no host read of the
    ids' range as ``torch.bincount`` makes on the card."""
    E, D = w_in.shape[0], x.shape[-1]
    bounds = torch.searchsorted(expert, torch.arange(
        E + 1, device=x.device, dtype=expert.dtype))
    C = _host_count((bounds[1:] - bounds[:-1]).max(), -(-x.shape[0] // E))
    pos = torch.arange(x.shape[0], device=x.device) - bounds[expert]
    xp = x.new_zeros(E, C, D)
    xp[expert, pos] = x
    h = F.silu(torch.bmm(xp, w_gate)) * torch.bmm(xp, w_in)   # [E, C, F]
    return torch.bmm(h, w_out)[expert, pos]


def _moe_local(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The prefill path: the (token, expert) pairs sorted by expert (a
    stable sort, as JAX's ``argsort``), the grouped SwiGLU, gates applied in
    the activation dtype and the rows added back per token in ``x``'s
    dtype."""
    B, T, D = x.shape
    xf = x.reshape(-1, D)
    gates, idx = _route(xf, p.router, cfg.top_k)
    flat_e = idx.reshape(-1)                                  # [N*K]
    order = torch.argsort(flat_e, stable=True)
    src = order // cfg.top_k                                  # token of a row
    y = _expert_ffn(p.w_in, p.w_gate, p.w_out, xf[src], flat_e[order])
    y = y * gates.reshape(-1)[order][:, None].to(y.dtype)
    return torch.zeros_like(xf).index_add_(0, src, y).reshape(B, T, D)


def _moe_token_gather(p: MoE, x: torch.Tensor, cfg: ArchConfig
                      ) -> torch.Tensor:
    """The decode path: each token through its ``top_k`` experts' weights,
    gathered per token (``[N, K, d, F]``), with no host synchronisation.
    The contractions are JAX's einsums written as batched products over the
    gathered weights as they lie: per (token, expert) ``x w`` over d, then
    one product over (expert, F) for the gated output."""
    B, T, D = x.shape
    xf = x.reshape(-1, D)
    N, K = xf.shape[0], cfg.top_k
    gates, idx = _route(xf, p.router, K)
    w_in, w_g, w_o = p.w_in[idx], p.w_gate[idx], p.w_out[idx]
    xk = xf[:, None, None, :]                                 # [N, 1, 1, d]
    h = F.silu(xk @ w_g) * (xk @ w_in)                        # [N, K, 1, F]
    h = h * gates[..., None, None].to(h.dtype)
    y = h.reshape(N, 1, -1) @ w_o.reshape(N, -1, D)           # [N, 1, d]
    return y.reshape(B, T, D).to(x.dtype)


# ------------------------------------------------- MoE: expert parallelism
#: the slots a destination shard gives a rank's (token, expert) pairs, as a
#: multiple of an even share (the JAX package's ``capacity_factor``)
CAPACITY_FACTOR = 1.25


def _ep_send(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
             E_loc: int, ep: int):
    """A shard's half of the dispatch (the JAX ``_moe_ep_body`` up to its
    first ``all_to_all``): its N tokens routed, each (token, k) pair
    numbered within its destination shard in the flattened (token, k)
    order, and the first ``cap = ceil(N K / ep * CAPACITY_FACTOR)`` of
    each destination laid into ``send_x`` [ep, cap, D] with their local
    expert ids ``send_e`` [ep, cap] (``E_loc`` marks an empty slot); the
    pairs past ``cap`` drop. Returns (send_x, send_e, route), ``route`` =
    (gates, destination, slot) of each pair for the combine, a dropped
    pair's slot being ``cap``."""
    N, D = xf.shape
    K = cfg.top_k
    gates, idx = _route(xf, router, K)
    dest = (idx // E_loc).reshape(-1)                         # [N*K]
    cap = max(1, int(math.ceil(N * K / ep * CAPACITY_FACTOR)))
    pos = (F.one_hot(dest, ep).cumsum(0) - 1).gather(1, dest[:, None])[:, 0]
    slot = torch.where(pos < cap, pos, cap)     # column cap: the dropped
    src = torch.arange(N * K, device=xf.device) // K
    send_x = xf.new_zeros(ep, cap + 1, D).index_put((dest, slot), xf[src])
    send_e = torch.full((ep, cap + 1), E_loc, dtype=idx.dtype,
                        device=xf.device).index_put(
                            (dest, slot), (idx % E_loc).reshape(-1))
    return send_x[:, :cap], send_e[:, :cap], (gates, dest, slot)


def _ep_experts(w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor,
                recv_x: torch.Tensor, recv_e: torch.Tensor) -> torch.Tensor:
    """The shard's experts over the rows it received ([ep, cap, D] and their
    local ids): the grouped SwiGLU (``_expert_ffn``) over the filled slots,
    zeros in the empty ones. One host read: the count of filled slots
    (every one, ``ep * cap``, on the meta device)."""
    E_loc, D = w_in.shape[0], recv_x.shape[-1]
    rx, re = recv_x.reshape(-1, D), recv_e.reshape(-1)
    live = torch.argsort(re, stable=True)[
        :_host_count((re < E_loc).sum(), re.numel())]
    y = rx.new_zeros(rx.shape).index_put(
        (live,), _expert_ffn(w_in, w_gate, w_out, rx[live], re[live]))
    return y.reshape(recv_x.shape)


def _ep_combine(back: torch.Tensor, route) -> torch.Tensor:
    """A shard's half of the combine: each kept pair's expert output back
    from its destination ``back`` [ep, cap, D], weighted by its gate, and
    each token's K pairs summed in k order (a dropped pair adds nothing):
    no atomics, so a token's row does not depend on where it lies."""
    gates, dest, slot = route
    picked = F.pad(back, (0, 0, 0, 1))[dest, slot]           # [N*K, D]
    picked = picked * gates.reshape(-1)[:, None].to(picked.dtype)
    return picked.reshape(*gates.shape, -1).sum(1)


def _ep_partial(w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor,
                router: torch.Tensor, xf: torch.Tensor, cfg: ArchConfig,
                lo: int, mode: str) -> torch.Tensor:
    """The JAX ``body_dec`` before its ``psum``: every token's output from
    the shard's experts ``[lo, lo + E_loc)`` only, its other pairs masked
    out. Decode gathers each token's experts' weights (the masked token
    gather, no host read); a longer input sorts the shard's pairs through
    the grouped SwiGLU (one host read: the count of local pairs, an even
    share of them on the meta device) and sums each token's pairs in k
    order."""
    N, D = xf.shape
    K, E_loc = cfg.top_k, w_in.shape[0]
    gates, idx = _route(xf, router, K)
    local = (idx >= lo) & (idx < lo + E_loc)
    if mode == "decode":
        e = (idx - lo).clamp(0, E_loc - 1)
        xk = xf[:, None, None, :]
        h = F.silu(xk @ w_gate[e]) * (xk @ w_in[e])             # [N, K, 1, F]
        h = h * (gates * local)[..., None, None].to(h.dtype)
        y = h.reshape(N, 1, -1) @ w_out[e].reshape(N, -1, D)
        return y.reshape(N, D).to(xf.dtype)
    e = torch.where(local, idx - lo, E_loc).reshape(-1)
    rows = torch.argsort(e, stable=True)[:_host_count(
        local.sum(), -(-N * K * E_loc // cfg.n_experts))]
    y = _expert_ffn(w_in, w_gate, w_out, xf[rows // K], e[rows])
    y = y * gates.reshape(-1)[rows][:, None].to(y.dtype)
    return xf.new_zeros(N * K, D).index_put((rows,), y).reshape(
        N, K, D).sum(1)


def _a2a_bytes(t: torch.Tensor, ep: int) -> int:
    """What one rank sends to the others in an ``all_to_all`` of ``t``."""
    return t.numel() * t.element_size() * (ep - 1) // ep


def _moe_dispatch(p: MoE, xl: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx
                  ) -> torch.Tensor:
    """The dispatch branch on a rank: its tokens ``xl`` to the experts'
    shards over ``ctx.ep_axes`` (``all_to_all`` of the rows and of their
    local expert ids), the shard's experts, the outputs back (a second
    ``all_to_all``) and the gate-weighted combine: the paper's Stage-2
    traffic."""
    xf = xl.reshape(-1, xl.shape[-1])
    ep, axes = ctx.ep_size, ctx.ep_axes
    send_x, send_e, route = _ep_send(xf, p.router, cfg, p.w_in.shape[0], ep)
    recv_x = exchange(send_x, ctx, axes)
    recv_e = all_to_all(send_e, ctx, axes)
    back = exchange(_ep_experts(p.w_in, p.w_gate, p.w_out, recv_x, recv_e),
                    ctx, axes)
    st = ctx.stats
    st.dropped = st.dropped + (route[2] == send_x.shape[1]).sum()
    st.pairs += route[1].numel()
    st.a2a_calls += 3
    st.a2a_bytes += 2 * _a2a_bytes(send_x, ep) + _a2a_bytes(send_e, ep)
    return _ep_combine(back, route).reshape(xl.shape)


def _moe_replicated(p: MoE, x: torch.Tensor, cfg: ArchConfig,
                    ctx: ShardCtx, mode: str) -> torch.Tensor:
    """The JAX decode branch (``body_dec``): the tokens replicated inside the
    EP domain (gathered over its data axes), each rank's experts' share of
    every token, summed over ``ep_axes`` (``all_reduce``), the rank's rows
    kept."""
    gather = tuple(a for a in ctx.batch_axes if a in ctx.ep_axes)
    rest = tuple(a for a in ctx.ep_axes if a not in gather)
    xg = gather_partial(copy_to(x, ctx, rest), ctx, gather, 0)
    B, T, D = xg.shape
    lo = ctx.index(ctx.ep_axes) * p.w_in.shape[0]
    part = _ep_partial(p.w_in, p.w_gate, p.w_out, p.router,
                       xg.reshape(-1, D), cfg, lo, mode)
    y = reduce_from(part.reshape(B, T, D), ctx, ctx.ep_axes)
    return scatter_to(y, ctx, gather, 0)


def moe_apply(p: MoE, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """x: [B, T, D] (the rank's rows). Plus the shared experts (column- and
    row-parallel as a SwiGLU under TP). The JAX ``moe_apply``'s three
    branches, picked by its rule:

    * local, with no mesh, one EP rank or experts the EP ranks do not
      divide: the token gather for decode, the sorted grouped products
      otherwise (train included);
    * dispatch, when the model axis divides T: the sequence split over
      "model", each rank's tokens dispatched to the experts' shards and
      combined (``_moe_dispatch``), the blocks gathered back over "model";
    * replicated otherwise (decode, an odd prompt): ``_moe_replicated``.

    ``ctx.stats`` counts the branches, pairs dropped and ``all_to_all``
    bytes."""
    B, T, D = x.shape
    ep = 1 if ctx is None else ctx.ep_size
    if ep == 1 or cfg.n_experts % ep:
        branch = "local"
        y = (_moe_token_gather if mode == "decode" else _moe_local)(p, x, cfg)
    elif T % ctx.model_size == 0:
        branch, mdl = "dispatch", ctx.model_axis
        y = gather_from(_moe_dispatch(p, scatter_to(x, ctx, mdl, 1), cfg,
                                      ctx), ctx, mdl, 1)
    else:
        branch, y = "replicated", _moe_replicated(p, x, cfg, ctx, mode)
    if ctx is not None:
        ctx.stats.branches[branch] = ctx.stats.branches.get(branch, 0) + 1
    if p.shared is not None:
        y = y + p.shared(x, ctx)
    return y


# ------------------------------------------------------------ Mamba2 (SSD)
class SSD(nn.Module):
    """Mamba2 mixer parameters, named as the JAX ``ssd_init`` pytree. The
    fused input projection ``w_in`` gives ``[z, x, B, C, dt]``; ``A_log``,
    ``D``, ``dt_bias`` and the norm gain stay float32 in any model dtype."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_head_dim
        N = cfg.ssm_state
        self.w_in = Dense(d, 2 * d_in + 2 * N + H, dtype=dtype, device=device)
        self.conv = nn.Parameter(
            torch.zeros(cfg.ssm_conv, d_in + 2 * N, dtype=dtype,
                        device=device), requires_grad=False)
        for name, fill in (("A_log", 0.0), ("D", 1.0), ("dt_bias", 0.0)):
            self.register_parameter(name, nn.Parameter(
                torch.full((H,), fill, dtype=torch.float32, device=device),
                requires_grad=False))
        self.norm = RMSNorm(d_in, device=device)
        self.w_out = Dense(d_in, d, dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 1/d_in) projections, N(0, 0.2^2) conv taps,
        A_log = 0, D = 1, dt_bias = 0, unit norm."""
        self.w_in.init(generator)
        normal_(self.conv, generator, 0.2)
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.init(generator)
        self.w_out.init(generator)


def ssd_init(cfg: ArchConfig, *, dtype=torch.bfloat16, device=None) -> SSD:
    return SSD(cfg, dtype=dtype, device=device)


def _causal_conv(x: torch.Tensor, taps: torch.Tensor,
                 prev: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time, in float32. x: [B, T, C]; taps:
    [W, C]; prev: the W-1 earlier steps [B, W-1, C], or None for zeros.
    Returns (y [B, T, C] float32, the last W-1 steps of ``[prev, x]`` in
    x's dtype: the window the next call resumes from, a copy, so that a
    prefill's caches of every layer do not hold each layer's whole
    ``[prev, x]``)."""
    B, T, C = x.shape
    W = taps.shape[0]
    if prev is None:
        prev = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    seq = torch.cat([prev, x], 1)                         # [B, W-1+T, C]
    t, s = taps.float(), seq.float()
    y = s[:, 0:T] * t[0]
    for i in range(1, W):
        y = y + s[:, i:i + T] * t[i]
    return y, seq[:, T:].clone()


def ssd_apply(p: SSD, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
              cache: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D]. Returns (y, new_cache) with cache ``{"conv":
    [B, W-1, d_in+2N] (model dtype), "state": [B, H, hd, N] float32}``.

    The causal depthwise conv of width W runs over ``[x, B, C]`` in float32
    with a window of W-1 earlier steps: zeros for a full prefill, the cached
    window for a suffix prefill (``cache`` from a prefill of the prefix) and
    for decode (T=1). Decode writes the new window and state into the given
    cache in place; a prefill never writes into ``cache`` (it may be a
    snapshot the prefix index still holds).
    """
    B, T, d = x.shape
    d_in = cfg.ssm_expand * d
    hd, N = cfg.ssm_head_dim, cfg.ssm_state
    H = d_in // hd
    zxbcdt = p.w_in(x)
    z = zxbcdt[..., :d_in]
    conv_in = zxbcdt[..., d_in:2 * d_in + 2 * N]          # [x, B, C]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    acc, new_conv = _causal_conv(conv_in, p.conv,
                                 None if cache is None else cache["conv"])
    conv_out = F.silu(acc)
    xh = conv_out[..., :d_in].reshape(B, T, H, hd)
    Bc = conv_out[..., d_in:d_in + N]
    Cc = conv_out[..., d_in + N:]
    A = -torch.exp(p.A_log)
    dt_s = F.softplus(dt.float() + p.dt_bias)
    # decode writes the new state over the cache's (in place, no copy)
    y, state = kops.ssd(xh, Bc, Cc, dt_s, A, p.D,
                        init_state=None if cache is None else cache["state"],
                        out_state=cache["state"] if mode == "decode" else None)
    y = y.reshape(B, T, d_in).to(x.dtype)
    y = rmsnorm(p.norm.g, y * F.silu(z))
    out = p.w_out(y)
    if mode == "decode":
        cache["conv"].copy_(new_conv)
        return out, cache
    if mode == "train":
        return out, None
    return out, {"conv": new_conv, "state": state}


# -------------------------------------------------- RG-LRU (RecurrentGemma)
_RGLRU_BLOCKS = 16      # Griffin's block-diagonal gate heads
_RGLRU_C = 8.0          # a = sigmoid-gated power of Lambda: exp(-c r softplus)


class RGLRU(nn.Module):
    """Griffin recurrent block parameters, named as the JAX ``rglru_init``
    pytree: branch and gate projections ``w_x``/``w_gate_branch``
    ``[d, w]``, the temporal conv taps ``[ssm_conv, w]``, the block-diagonal
    gates ``gate_in``/``gate_rec`` ``[nb, w/nb, w/nb]``, the per-channel
    decay ``a_param`` (float32 in any model dtype) and ``w_out_rg``.

    Under tensor parallelism (``localize``) the projections, the gates and
    the decay hold the rank's block of the channels (whole gate blocks) and
    ``w_out_rg`` its rows; the conv taps stay whole (JAX's placement) and
    the rank reads its columns, from ``cols`` on."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru_width or d
        nb = rglru_blocks(cfg)
        kb = w // nb
        self.w_x = Dense(d, w, dtype=dtype, device=device)
        self.w_gate_branch = Dense(d, w, dtype=dtype, device=device)

        def param(shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.conv = param((cfg.ssm_conv, w))
        self.gate_in = param((nb, kb, kb))
        self.gate_rec = param((nb, kb, kb))
        self.a_param = param((w,), torch.float32)
        self.w_out_rg = Dense(w, d, dtype=dtype, device=device)
        self.tp: Optional[ShardCtx] = None     # set by localize under TP
        self.cols = 0                          # the rank's first channel

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 1/d_in) projections, N(0, 0.2^2) conv taps,
        N(0, 1/kb) gates, and Lambda = linspace(0.9, 0.999, w) as
        ``a_param = log(expm1(Lambda^(1/c)))`` (a rank's shard: its block
        of the whole width's)."""
        self.w_x.init(generator)
        self.w_gate_branch.init(generator)
        normal_(self.conv, generator, 0.2)
        kb = self.gate_in.shape[1]
        normal_(self.gate_in, generator, kb ** -0.5)
        normal_(self.gate_rec, generator, kb ** -0.5)
        lam = torch.linspace(0.9, 0.999, logical_shape(self.a_param)[0],
                             dtype=torch.float32)
        self.a_param.copy_(shard_tensor(
            torch.log(torch.expm1(lam ** (1.0 / _RGLRU_C))),
            getattr(self.a_param, "shard", None)))
        self.w_out_rg.init(generator)

    def localize(self, ctx: ShardCtx) -> None:
        """After the parameters took their shards (``Model``): the rank
        runs its block of the channels where they are split
        (``lm._refuse_tp`` has checked that the model axis divides the gate
        blocks)."""
        split = getattr(self.a_param, "shard", None)
        if split is not None:
            self.tp = ctx
            self.cols = split.index * self.a_param.shape[0]


def rglru_blocks(cfg: ArchConfig) -> int:
    """The block-diagonal gates' block count: 16 where they divide the
    width, else one."""
    w = cfg.rglru_width or cfg.d_model
    return _RGLRU_BLOCKS if w % _RGLRU_BLOCKS == 0 else 1


def rglru_init(cfg: ArchConfig, *, dtype=torch.bfloat16, device=None) -> RGLRU:
    return RGLRU(cfg, dtype=dtype, device=device)


def rglru_apply(p: RGLRU, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D]. Returns (y, new_cache) with cache ``{"conv":
    [B, W-1, w] (model dtype), "state": [B, w] float32}``, carried and
    written as in ``ssd_apply``.

    The branch ``w_x x`` runs through the causal conv (no activation); the
    block-diagonal gates read the conv output cast to the model dtype, the
    gated input uses it in float32; ``a = exp(-c r softplus(a_param))`` and
    the input scale ``beta = sqrt(1 - a^2)`` feed the recurrence, whose
    float32 output, cast to the model dtype, is gated by ``gelu`` (tanh
    form, as ``jax.nn.gelu``) of the gate branch.

    Under tensor parallelism (``p.tp``, ``RGLRU.localize``) every size is
    the rank's: its ``w / m`` channels through its columns of the conv
    taps, its gate blocks and its recurrence, its cache ``conv [B, W-1,
    w/m]`` and ``state [B, w/m]``; x enters through ``copy_to`` and
    ``w_out_rg``'s partial products are summed over the model axis (JAX's
    ``("batch", None, "model")`` constraints on the branch, the conv output
    and the gates)."""
    B, T, _ = x.shape
    w = p.a_param.numel()                                       # the rank's
    if p.tp is not None:
        x = copy_to(x, p.tp, p.tp.model_axis)
    gate_branch = F.gelu(p.w_gate_branch(x), approximate="tanh")
    xt, new_conv = _causal_conv(p.w_x(x), p.conv[:, p.cols:p.cols + w],
                                None if cache is None else cache["conv"])
    nb, kb = p.gate_rec.shape[0], p.gate_rec.shape[1]
    xtb = xt.to(x.dtype).reshape(B, T, nb, kb)
    rt = torch.sigmoid(torch.einsum("btnk,nkj->btnj", xtb, p.gate_rec)
                       .reshape(B, T, w).float())
    it = torch.sigmoid(torch.einsum("btnk,nkj->btnj", xtb, p.gate_in)
                       .reshape(B, T, w).float())
    log_a = -_RGLRU_C * rt * F.softplus(p.a_param)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    h, state = kops.rglru(a, beta * (xt * it),
                          None if cache is None else cache["state"])
    y = p.w_out_rg(h.to(x.dtype) * gate_branch)
    if p.tp is not None:
        y = reduce_from(y, p.tp, p.tp.model_axis)
    if mode == "decode":
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)
        return y, cache
    if mode == "train":
        return y, None
    return y, {"conv": new_conv, "state": state}
