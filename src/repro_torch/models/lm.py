"""Model assembly for every family of the JAX package: the dense decoder
(and the VLM backbone, which also takes input embeddings), the mixture of
experts (DeepSeek style: ``first_dense`` dense layers, then MoE layers;
DeepSeek-V3's with MLA attention and an MTP head), the attention-free SSM
(Mamba2), the hybrid (RecurrentGemma: RG-LRU blocks and local attention)
and the encoder-decoder (Seamless: an encoder over source embeddings, and
a cross-attention sublayer in each decoder layer): embedding, ``count``
blocks of sublayers per segment, final norm and the unembedding (tied to
the embedding, or its own ``unembed``).

Public API, in the JAX package's layouts (``Model`` of ``repro.models.lm``):
  init(generator)                      -> fills the parameters in place
  loss(batch)                          -> scalar float32 (differentiable)
  prefill(batch, caches=None, pos=0)   -> (logits_last [B,1,Vp], caches)
  decode_step(caches, tok, pos)        -> (logits [B,1,Vp], caches)
  init_cache(batch_size, max_len, kv_dtype=None, src_len=0) -> zero caches

``batch`` holds ``tokens`` [B, T] or ``inputs_embeds`` [B, T, d], and
``src_embeds`` [B, S, d] for an encoder-decoder; ``tok`` of ``decode_step``
is [B, 1] ints or [B, 1, d] embeddings. ``loss`` also reads ``labels``
[B, T] (and ``labels2`` for the MTP term of a model with ``mtp``).

Parameters are built with ``requires_grad=False`` and serving runs under
``no_grad``; training turns gradients on with ``Model.requires_grad_()``
(``training.trainer.init_train_state`` does).

``build_model(cfg, ctx=ShardCtx(mesh=...))`` builds a rank's shard of the
model (see ``Model``): the batch a call takes is the rank's rows, its
caches the rank's heads, its logits the whole vocab's.

The cache keeps the JAX nesting: a list per segment, a list per sublayer,
then ``{"mix": {...}}`` with a leading ``count`` axis: ``{"k", "v"}`` of
``[count, B, S, n_kv, hd]`` for attention (``S <= window`` for a local
layer), ``{"c": [count, B, S, kv_lora_rank], "kr": [count, B, S,
rope_head_dim]}`` for MLA, ``{"conv": [count, B, W-1, d_in+2N], "state":
[count, B, H, hd, N] float32}`` for the SSM and ``{"conv": [count, B, W-1,
w], "state": [count, B, w] float32}`` for an RG-LRU block; an
encoder-decoder's entries also hold the cross K/V ``"xk"``, ``"xv"`` of
``[count, B, src_len, n_kv, hd]`` beside ``"mix"``.
``decode_step`` writes the new token into the caches it is given, in place,
and returns them; ``prefill`` builds new ones and never writes into the
caches it resumes from. ``pos`` of ``decode_step`` is an int or a [B]
tensor of per-sequence positions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from .blocks import (Attention, AttnDims, attn_apply, attn_init, cross_apply,
                     ffn_apply, ffn_init, mla_apply, mla_init, moe_apply,
                     moe_init, rglru_apply, rglru_init, ssd_apply, ssd_init)
from .layers import Dense, RMSNorm, normal_, softmax_xent, xent_terms
from .sharding import (HEAD_PAD, ShardCtx, all_gather, all_reduce, copy_to,
                       pad_to_multiple, reduce_from)

__all__ = ["Model", "build_model", "Segment", "plan_segments"]


@dataclass(frozen=True)
class Segment:
    """``count`` repetitions of the sublayer pattern ``kinds``; each entry is
    (mixer_kind, is_moe, window). ``cross``: each layer also attends to the
    encoder's memory."""

    count: int
    kinds: Tuple[Tuple[str, bool, int], ...]
    cross: bool = False


def _mixer_kind(cfg: ArchConfig, layer: int) -> str:
    """The config's layer kind, with MLA in place of attention when
    ``use_mla``."""
    kind = cfg.layer_kind(layer)
    return "mla" if kind == "attn" and cfg.use_mla else kind


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    """As the JAX ``plan_segments``: a hybrid repeats its ``block_pattern``
    unit ``n_layers // len(pattern)`` times, then a tail segment of the
    remaining sublayers, with the window on the attention sublayers only;
    a mixture of experts with ``first_dense`` layers is a dense segment of
    those and an MoE segment of the rest (of no blocks when ``n_layers ==
    first_dense``); any other model is one segment of ``n_layers`` layers
    (MoE when it has experts; with cross-attention for an
    encoder-decoder)."""
    w = cfg.window
    if cfg.block_pattern:
        def kinds(n):
            return tuple((_mixer_kind(cfg, i), cfg.is_moe_layer(i),
                          w if cfg.layer_kind(i) == "attn" else 0)
                         for i in range(n))
        n_units, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
        segs = [Segment(n_units, kinds(len(cfg.block_pattern)))] \
            if n_units else []
        return segs + ([Segment(1, kinds(rem))] if rem else [])
    if cfg.n_experts and cfg.first_dense:
        return [Segment(cfg.first_dense, ((_mixer_kind(cfg, 0), False, w),)),
                Segment(cfg.n_layers - cfg.first_dense,
                        ((_mixer_kind(cfg, cfg.first_dense), True, w),))]
    return [Segment(cfg.n_layers, ((_mixer_kind(cfg, 0), cfg.n_experts > 0,
                                    w),), cross=cfg.enc_layers > 0)]


_MIXER_INIT = {"attn": attn_init, "mla": mla_init, "ssm": ssd_init,
               "rec": rglru_init}


class Layer(nn.Module):
    """Attention, MLA or RG-LRU (``rec``): rmsnorm -> mixer -> residual ->
    [rmsnorm -> cross-attention -> residual] -> rmsnorm -> FFN -> residual,
    the FFN a SwiGLU (``ffn``) or, with ``is_moe``, the experts
    (``ffn_moe``, the JAX pytree's name), the cross-attention (``ln_x``,
    ``xattn``) with ``cross``. SSM (Mamba2): rmsnorm -> SSD mixer ->
    residual, no FFN. ``window`` is the local-attention window of an
    attention sublayer (0: full).

    ``forward`` takes and returns the layer's cache entry: ``{"mix": ...}``
    and, for a cross layer, ``"xk"``/``"xv"`` (None for ``encode``)."""

    def __init__(self, cfg: ArchConfig, kind: str, window: int = 0,
                 is_moe: bool = False, cross: bool = False, *, dtype,
                 device, ctx: Optional[ShardCtx] = None):
        super().__init__()
        self.kind, self.window, self.ctx = kind, window, ctx
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.mix = _MIXER_INIT[kind](cfg, dtype=dtype, device=device)
        self.ln2 = self.ffn = self.ffn_moe = self.ln_x = self.xattn = None
        if kind != "ssm":
            self.ln2 = RMSNorm(cfg.d_model, device=device)
            if is_moe:
                self.ffn_moe = moe_init(cfg, dtype=dtype, device=device)
            else:
                self.ffn = ffn_init(cfg, dtype=dtype, device=device)
        if cross:
            self.ln_x = RMSNorm(cfg.d_model, device=device)
            self.xattn = attn_init(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.mix, self.ln2, self.ffn, self.ffn_moe,
                  self.ln_x, self.xattn):
            if m is not None:
                m.init(generator)

    def forward(self, x, *, cfg: ArchConfig, mode: str, cache=None, pos=0,
                memory=None):
        mix_in = None if cache is None else cache.get("mix")
        h = self.ln1(x, cfg.norm_eps)
        if self.kind == "ssm":
            h, mix_cache = ssd_apply(self.mix, h, cfg=cfg, mode=mode,
                                     cache=mix_in)
            return x + h, (None if mix_cache is None else {"mix": mix_cache})
        if self.kind == "rec":
            h, mix_cache = rglru_apply(self.mix, h, cfg=cfg, mode=mode,
                                       cache=mix_in)
        elif self.kind == "mla":
            h, mix_cache = mla_apply(self.mix, h, cfg=cfg, mode=mode,
                                     cache=mix_in, pos=pos)
        else:
            h, mix_cache = attn_apply(self.mix, h, cfg=cfg, mode=mode,
                                      cache=mix_in, pos=pos,
                                      window=self.window)
        x = x + h
        new = {} if mix_cache is None else {"mix": mix_cache}
        if self.xattn is not None and (
                memory is not None or (cache is not None and "xk" in cache)):
            h, new["xk"], new["xv"] = cross_apply(
                self.xattn, self.ln_x(x, cfg.norm_eps), cfg=cfg, mode=mode,
                memory=memory, cache=cache)
            x = x + h
        h = self.ln2(x, cfg.norm_eps)
        if self.ffn_moe is not None:
            x = x + moe_apply(self.ffn_moe, h, cfg=cfg, mode=mode,
                              ctx=self.ctx)
        else:
            x = x + ffn_apply(self.ffn, h, self.ctx)
        return x, (new or None)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of cache entries (dicts of dicts of
    tensors)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Model(nn.Module):
    """Causal LM of any family. Parameters are ``embed`` [Vp, d], ``ln_f``,
    ``unembed`` [d, Vp] when the embeddings are not tied, and one ``seg{i}``
    ModuleList per segment holding ``count`` blocks of sublayers (the JAX
    pytree's ``vmap``-stacked ``count`` axis, unstacked); an
    encoder-decoder adds ``encoder`` (``enc_layers`` layers) and
    ``enc_ln_f``; a model with ``mtp`` adds ``mtp_proj`` [2d, d] and
    ``mtp_layer`` (one layer, built as layer ``n_layers - 1``). Serving
    never reads the MTP head: it is the training loss's. ``remat``: the
    train mode recomputes each layer in the backward instead of keeping its
    activations (``torch.utils.checkpoint``; the values do not change), as
    the JAX launcher's ``--remat``.

    Under a mesh (``ctx``) the model is a rank's shard: each parameter is
    built at its shard's shape, its ``Split`` as its ``shard`` (``launch.
    shardings.param_placement``; built whole on the ``meta`` device first,
    so the blocks' code is the same on every mesh), the vocab split over "model"
    where the embedding is (vocab-parallel lookup and cross-entropy;
    ``prefill`` and ``decode_step`` gather the logits), the batch the rank's
    rows, the loss the mean over the whole batch of every data rank. SSM,
    hybrid, encoder-decoder and MLA models run data parallel only (one rank
    on "model")."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16,
                 device=None, remat: bool = False,
                 ctx: Optional[ShardCtx] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.ctx = ctx = ShardCtx() if ctx is None else ctx
        self.segments = plan_segments(cfg)
        sharded = ctx.mesh is not None
        if sharded:
            _refuse_tp(cfg, ctx)
        final_device, device = device, ("meta" if sharded else device)
        self.embed = nn.Parameter(
            torch.zeros(self.vocab_padded, cfg.d_model, dtype=dtype,
                        device=device), requires_grad=False)
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.unembed = None if cfg.tie_embeddings else Dense(
            cfg.d_model, self.vocab_padded, dtype=dtype, device=device)
        for si, seg in enumerate(self.segments):
            self.add_module(f"seg{si}", nn.ModuleList(
                nn.ModuleList(Layer(cfg, kind, window, is_moe, seg.cross,
                                    dtype=dtype, device=device, ctx=ctx)
                              for kind, is_moe, window in seg.kinds)
                for _ in range(seg.count)))
        self.encoder = self.enc_ln_f = self.mtp_proj = self.mtp_layer = None
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(
                Layer(cfg, _mixer_kind(cfg, 0), 0, cfg.is_moe_layer(0),
                      dtype=dtype, device=device, ctx=ctx)
                for _ in range(cfg.enc_layers))
            self.enc_ln_f = RMSNorm(cfg.d_model, device=device)
        if cfg.mtp:
            last = cfg.n_layers - 1
            self.mtp_proj = Dense(2 * cfg.d_model, cfg.d_model, dtype=dtype,
                                  device=device)
            self.mtp_layer = nn.ModuleList([Layer(
                cfg, _mixer_kind(cfg, last), 0, cfg.is_moe_layer(last),
                dtype=dtype, device=device, ctx=ctx)])
        self.kv_heads = cfg.n_kv         # KV heads a decode cache stores
        if sharded:
            self._localize(final_device)

    def _localize(self, device) -> None:
        """Replace each (meta) parameter by the rank's shard on ``device``,
        its ``Split`` as the parameter's ``shard``; each attention layer
        takes its heads' block of the q->kv map."""
        from ..launch.shardings import param_placement   # launch imports us
        for name, p in list(self.named_parameters()):
            split = param_placement(name, tuple(p.shape), self.cfg, self.ctx)
            shape = list(p.shape)
            if split is not None:
                shape[split.dim] //= split.parts
            new = nn.Parameter(torch.zeros(shape, dtype=p.dtype,
                                           device=device), requires_grad=False)
            new.shard = split
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner) if owner else self, leaf, new)
        for m in self.modules():
            if isinstance(m, Attention):
                m.localize(self.ctx)
                if getattr(m.wk.w, "shard", None) is not None:
                    self.kv_heads = m.wk.w.shape[1] // self.cfg.hd

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 16; padded logits are -1e30."""
        return pad_to_multiple(self.cfg.vocab, HEAD_PAD)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the JAX ``Model.init`` shapes and scales:
        N(0, 1/d_model) embedding, N(0, 1/d_in) dense weights, zero biases,
        unit norms, zeroed padded-head ``wo`` rows."""
        normal_(self.embed, generator, 1.0 / math.sqrt(self.cfg.d_model))
        for m in (self.ln_f, self.unembed, self.enc_ln_f, self.mtp_proj):
            if m is not None:
                m.init(generator)
        layers = [layer for si in range(len(self.segments))
                  for block in self._blocks(si) for layer in block]
        for layer in layers + list(self.encoder or ()) + \
                list(self.mtp_layer or ()):
            layer.init(generator)
        return self

    # ------------------------------------------------------------- backbone
    def _blocks(self, si: int) -> nn.ModuleList:
        return getattr(self, f"seg{si}")

    def _run_segments(self, x, mode: str, caches=None, pos=0, sink=None,
                      memory=None):
        """Returns (x, caches: list per segment). Decode writes into the
        given caches and returns them. With ``sink``, each layer's cache
        entry goes to ``sink(si, i, c, entry)`` as the layer returns it
        (segment ``si``, sublayer ``i``, block ``c``) and none is kept:
        caches is None. A segment of no blocks gives caches with a ``count``
        axis of 0, as JAX's scan over no blocks does. The train mode builds
        no caches (None), and with ``remat`` checkpoints each layer."""
        new_caches = []
        keep = sink is None and mode != "train"
        for si, seg in enumerate(self.segments):
            outs: List[List[Dict[str, Any]]] = [[] for _ in seg.kinds]
            for c, block in enumerate(self._blocks(si)):
                for i, layer in enumerate(block):
                    if mode == "train":
                        x = self._train_layer(layer, x, memory)
                        continue
                    ci = None if caches is None else _tree_map(
                        lambda t: t[c], caches[si][i])
                    x, nc = layer(x, cfg=self.cfg, mode=mode, cache=ci,
                                  pos=pos, memory=memory)
                    if sink is None:
                        outs[i].append(nc)
                    else:
                        sink(si, i, c, nc)
            if not keep:
                continue
            if mode == "decode":
                new_caches.append(caches[si])
            elif seg.count == 0:
                new_caches.append(self._empty_segment_cache(
                    seg, x.shape[0], x.shape[1],
                    None if caches is None else caches[si], memory))
            else:
                new_caches.append([_tree_map(lambda *ts: torch.stack(ts),
                                             *per_layer)
                                   for per_layer in outs])
        return x, (new_caches if keep else None)

    def _train_layer(self, layer: "Layer", x: torch.Tensor, memory=None
                     ) -> torch.Tensor:
        """One layer in the train mode, recomputed in the backward when
        ``remat``."""
        def run(h, mem):
            return layer(h, cfg=self.cfg, mode="train", memory=mem)[0]
        if self.remat and torch.is_grad_enabled():
            return checkpoint(run, x, memory, use_reentrant=False)
        return run(x, memory)

    def _empty_segment_cache(self, seg: Segment, B: int, T: int, prefix,
                             memory):
        """The prefill caches of a segment of no blocks: zeros of ``count``
        0 over the ``T`` new positions and the prefix's."""
        src_len = 0 if memory is None else memory.shape[1]
        if prefix is not None:
            T += next(iter(prefix[0]["mix"].values())).shape[2]
            if "xk" in prefix[0]:
                src_len = prefix[0]["xk"].shape[2]
        return self._segment_cache(seg, B, T, self.dtype, src_len)

    def _embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        if "inputs_embeds" in batch:
            return torch.as_tensor(batch["inputs_embeds"],
                                   device=self.device).to(self.dtype)
        return self._lookup(batch["tokens"])

    def _lookup(self, tokens) -> torch.Tensor:
        """Rows of ``embed``; ``F.embedding``, whose backward on the card
        sums each row's gradient in a fixed order (indexing's backward adds
        with atomics, in an order that changes from run to run). With the
        vocab split, each rank looks up the tokens in its rows (zeros for
        the others) and the rows are summed over "model"."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        split = getattr(self.embed, "shard", None)
        if split is None:
            return F.embedding(tokens, self.embed)
        local = tokens - split.index * self.embed.shape[0]
        mine = (local >= 0) & (local < self.embed.shape[0])
        rows = F.embedding(torch.where(mine, local, 0), self.embed)
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return reduce_from(rows, self.ctx, split.axes)

    def _encode(self, src_embeds) -> torch.Tensor:
        """The encoder over the source embeddings [B, S, d]: bidirectional
        attention and the SwiGLU in each layer, then ``enc_ln_f``."""
        x = torch.as_tensor(src_embeds, device=self.device).to(self.dtype)
        for layer in self.encoder:
            x, _ = layer(x, cfg=self.cfg, mode="encode")
        return self.enc_ln_f(x, self.cfg.norm_eps)

    def _vocab_split(self):
        w = self.embed if self.unembed is None else self.unembed.w
        return getattr(w, "shard", None)

    def _local_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of the rank's block of the vocab (all of it when the
        vocab is not split), the padded tail at -1e30."""
        x = self.ln_f(x, self.cfg.norm_eps)
        split = self._vocab_split()
        if split is not None:
            x = copy_to(x, self.ctx, split.axes)
        logits = x @ self.embed.T if self.unembed is None else self.unembed(x)
        if self.vocab_padded != self.cfg.vocab:
            lo = 0 if split is None else split.index * logits.shape[-1]
            iota = lo + torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(iota < self.cfg.vocab, logits,
                                 torch.full_like(logits, -1e30))
        return logits

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The whole vocab's logits (gathered over "model" when split)."""
        split = self._vocab_split()
        logits = self._local_logits(x)
        return (logits if split is None else
                all_gather(logits, self.ctx, split.axes, logits.dim() - 1))

    def _xent(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The mean token cross-entropy of the final hidden states ``x``
        against ``labels``. With no mesh, ``softmax_xent`` of the logits.
        Under a mesh, the mean over the whole batch: the numerator and the
        count of labels summed over the data axes, and with the vocab split
        the log-sum-exp and the gold logit assembled over "model" from each
        rank's block (the row max and the sums of exponentials all-reduced):
        a rank holds its [B, T, V / m] block of float32 logits and never
        the whole vocab's (at full-width smollm-360m's B=8 x 1024 that block
        is 0.8 GB at m=2; gathered, the float32 logits would be 1.6 GB a
        rank, and their gradient as much again)."""
        ctx = self.ctx
        if ctx.mesh is None:
            return softmax_xent(self._local_logits(x), labels)
        split = self._vocab_split()
        if split is None:
            per_tok, valid = xent_terms(self._local_logits(x), labels)
        else:
            per_tok, valid = self._vocab_parallel_terms(x, labels, split)
        num = reduce_from(per_tok.sum(), ctx, ctx.batch_axes)
        count = all_reduce(valid.sum(), ctx, ctx.batch_axes)
        return num / count.clamp(min=1)

    def _vocab_parallel_terms(self, x, labels, split):
        """``xent_terms`` over a vocab split on "model": each rank's block
        of the logits, the row max and the sum of exponentials all-reduced
        into the log-sum-exp, the gold logit from the rank that holds it."""
        ctx, axes = self.ctx, split.axes
        logits = self._local_logits(x).float()
        n = logits.shape[-1]
        top = all_reduce(logits.detach().amax(-1), ctx, axes, op="max")
        lse = top + torch.log(reduce_from(
            torch.exp(logits - top[..., None]).sum(-1), ctx, axes))
        valid = labels != -100
        local = torch.where(valid, labels, 0).long() - split.index * n
        mine = (local >= 0) & (local < n)
        gold = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
        gold = reduce_from(torch.where(mine, gold, torch.zeros_like(gold)),
                           ctx, axes)
        return torch.where(valid, lse - gold, torch.zeros_like(lse)), valid

    # ----------------------------------------------------------------- train
    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The JAX ``Model.loss``: the encoder over ``src_embeds`` for an
        encoder-decoder, the embeddings (``tokens`` or ``inputs_embeds``),
        every segment in the train mode, the logits and the mean token
        cross-entropy against ``labels`` (``-100`` ignored). A model with
        ``mtp`` given ``labels2`` adds DeepSeek-V3's multi-token prediction:
        the final hidden state joined with the embeddings of ``labels``
        (clipped at 0), ``mtp_proj``, one step of ``mtp_layer`` and ``0.3 x``
        the cross-entropy of its logits against ``labels2``."""
        memory = None
        if self.encoder is not None:
            memory = self._encode(batch["src_embeds"])
        x = self._embed(batch)
        x, _ = self._run_segments(x, "train", memory=memory)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        loss = self._xent(x, labels)
        if self.mtp_layer is not None and "labels2" in batch:
            emb2 = self._lookup(labels.clamp(min=0))
            h2 = self.mtp_proj(torch.cat([x, emb2.to(x.dtype)], -1))
            h2 = self._train_layer(self.mtp_layer[0], h2)
            labels2 = torch.as_tensor(batch["labels2"], device=self.device)
            loss = loss + 0.3 * self._xent(h2, labels2)
        return loss

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], caches=None, pos: int = 0,
                sink=None):
        """Full prefill, or *suffix* prefill resuming from a reused prefix
        cache (``caches`` from a prefill of the first ``pos`` tokens). With
        ``sink``, each layer's cache entry is handed to ``sink(si, i, c,
        entry)`` before the next layer runs and the caches returned are
        None, so a long prompt's caches of every layer are never held at
        once.

        An encoder-decoder encodes ``batch["src_embeds"]`` unless the caches
        it resumes from hold cross K/V, which it then uses in their place
        (the JAX model encodes either way and reads the cached K/V)."""
        memory = None
        if self.encoder is not None and not (
                caches is not None and "xk" in caches[-1][0]):
            memory = self._encode(batch["src_embeds"])
        x = self._embed(batch)
        x, caches = self._run_segments(x, "prefill", caches=caches,
                                       pos=int(pos), sink=sink,
                                       memory=memory)
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, caches, tok, pos: Union[int, torch.Tensor]):
        """tok: [B, 1] int, or [B, 1, d] embeddings; pos: int or [B]
        positions (== current lengths)."""
        tok = torch.as_tensor(tok, device=self.device)
        B = tok.shape[0]
        pos = torch.as_tensor(pos, device=self.device).long().expand(B)
        x = tok.to(self.dtype) if tok.is_floating_point() \
            else self._lookup(tok)
        x, caches = self._run_segments(x, "decode", caches=caches, pos=pos)
        return self._logits(x), caches

    # ---------------------------------------------------------- cache specs
    def init_cache(self, batch_size: int, max_len: int,
                   kv_dtype: Optional[torch.dtype] = None, src_len: int = 0):
        """Zero caches. Attention stores the REAL kv-head count (a padded
        MHA model's padded heads are no-ops: decode crops them on insert)
        in ``kv_dtype`` (default: the model's dtype; ``torch.int8`` for
        codes of 1/32, as the JAX model's ``init_cache``), over ``min(max_len,
        window)`` slots for a local layer; MLA stores its latent and rope
        key over ``max_len`` slots; the SSM and RG-LRU blocks store their
        conv window in the model's dtype and their state in float32. An
        encoder-decoder given ``src_len`` also gets cross K/V over
        ``src_len`` encoder positions.

        int8 is refused for a model with SSM, RG-LRU or MLA layers and for
        cross K/V: the JAX model stores those leaves in ``kv_dtype`` too and
        reads the int8 codes as values (its SSD and RG-LRU blocks concatenate
        the conv window with new values unscaled, its MLA attends over the
        latent codes, its cross-attention over the K/V codes)."""
        kv_dtype = kv_dtype or self.dtype
        if kv_dtype == torch.int8:
            bad = sorted({kind for seg in self.segments
                          for kind, _, _ in seg.kinds if kind != "attn"})
            if self.encoder is not None and src_len:
                bad.append("cross K/V")
            if bad:
                raise ValueError(
                    f"{self.cfg.name}: an int8 cache holds attention K/V "
                    f"only; this model's cache has {bad} leaves, which the "
                    "JAX model would read as codes")
        return [self._segment_cache(seg, batch_size, max_len, kv_dtype,
                                    src_len) for seg in self.segments]

    def _segment_cache(self, seg: Segment, batch_size: int, max_len: int,
                       kv_dtype: torch.dtype, src_len: int):
        cfg = self.cfg
        dims = AttnDims.of(cfg)

        def zeros(shape, dtype=self.dtype):
            return torch.zeros((seg.count, batch_size) + shape, dtype=dtype,
                               device=self.device)

        def one(kind, window):
            if kind == "ssm":
                d_in = cfg.ssm_expand * cfg.d_model
                H, N = d_in // cfg.ssm_head_dim, cfg.ssm_state
                entry = {"mix": {
                    "conv": zeros((cfg.ssm_conv - 1, d_in + 2 * N)),
                    "state": zeros((H, cfg.ssm_head_dim, N), torch.float32)}}
            elif kind == "rec":
                w = cfg.rglru_width or cfg.d_model
                entry = {"mix": {"conv": zeros((cfg.ssm_conv - 1, w)),
                                 "state": zeros((w,), torch.float32)}}
            elif kind == "mla":
                entry = {"mix": {
                    "c": zeros((max_len, cfg.kv_lora_rank), kv_dtype),
                    "kr": zeros((max_len, cfg.rope_head_dim), kv_dtype)}}
            else:
                S = min(max_len, window) if window else max_len
                entry = {"mix": {n: zeros((S, self.kv_heads, dims.hd),
                                          kv_dtype) for n in ("k", "v")}}
            if cfg.enc_layers and src_len:
                for n in ("xk", "xv"):
                    entry[n] = zeros((src_len, dims.n_kv, dims.hd), kv_dtype)
            return entry

        return [one(kind, window) for kind, _, window in seg.kinds]


def _refuse_tp(cfg: ArchConfig, ctx: ShardCtx) -> None:
    """Tensor parallelism covers the dense and MoE families; the others
    raise rather than run replicated."""
    m = ctx.model_size
    if m == 1:
        return
    if m > ctx.head_pad:
        raise NotImplementedError(
            f"a model axis of {m} > {ctx.head_pad} ranks is not ported "
            "(ROADMAP queue 1 #8)")
    for what, bad in (("an SSM mixer", cfg.family == "ssm"),
                      ("an RG-LRU block", bool(cfg.block_pattern)),
                      ("an encoder-decoder", cfg.enc_layers > 0),
                      ("MLA attention", cfg.use_mla)):
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: tensor parallelism of {what} is the next "
                f"slice (ROADMAP queue 1 #8); run it with model_par=1 "
                "(data parallel)")


def build_model(cfg: ArchConfig, *, device=None, dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                remat: bool = False, ctx: Optional[ShardCtx] = None) -> Model:
    """Build on ``device`` (default: the card; raises without one). With a
    ``generator`` the weights are drawn from it; otherwise they are zero
    until :meth:`Model.init` or a ``load_state_dict``. Under a mesh
    (``ctx``), the rank's shard of the model; the same generator seed
    gives every mesh the same logical weights."""
    model = Model(cfg, dtype=dtype, device=resolve_device(device),
                  remat=remat, ctx=ctx)
    if generator is not None:
        model.init(generator)
    return model
