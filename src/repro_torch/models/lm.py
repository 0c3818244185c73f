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
  prefill(batch, caches=None, pos=0)   -> (logits_last [B,1,Vp], caches)
  decode_step(caches, tok, pos)        -> (logits [B,1,Vp], caches)
  init_cache(batch_size, max_len, kv_dtype=None, src_len=0) -> zero caches

``batch`` holds ``tokens`` [B, T] or ``inputs_embeds`` [B, T, d], and
``src_embeds`` [B, S, d] for an encoder-decoder; ``tok`` of ``decode_step``
is [B, 1] ints or [B, 1, d] embeddings.

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
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from .blocks import (AttnDims, attn_apply, attn_init, cross_apply, ffn_apply,
                     ffn_init, mla_apply, mla_init, moe_apply, moe_init,
                     rglru_apply, rglru_init, ssd_apply, ssd_init)
from .layers import Dense, RMSNorm, normal_
from .sharding import HEAD_PAD, pad_to_multiple

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
                 device):
        super().__init__()
        self.kind, self.window = kind, window
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
            return x + h, {"mix": mix_cache}
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
            x = x + moe_apply(self.ffn_moe, h, cfg=cfg, mode=mode)
        else:
            x = x + ffn_apply(self.ffn, h)
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
    never reads the MTP head: it is the training loss's."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.segments = plan_segments(cfg)
        self.embed = nn.Parameter(
            torch.zeros(self.vocab_padded, cfg.d_model, dtype=dtype,
                        device=device), requires_grad=False)
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.unembed = None if cfg.tie_embeddings else Dense(
            cfg.d_model, self.vocab_padded, dtype=dtype, device=device)
        for si, seg in enumerate(self.segments):
            self.add_module(f"seg{si}", nn.ModuleList(
                nn.ModuleList(Layer(cfg, kind, window, is_moe, seg.cross,
                                    dtype=dtype, device=device)
                              for kind, is_moe, window in seg.kinds)
                for _ in range(seg.count)))
        self.encoder = self.enc_ln_f = self.mtp_proj = self.mtp_layer = None
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(
                Layer(cfg, _mixer_kind(cfg, 0), 0, cfg.is_moe_layer(0),
                      dtype=dtype, device=device)
                for _ in range(cfg.enc_layers))
            self.enc_ln_f = RMSNorm(cfg.d_model, device=device)
        if cfg.mtp:
            last = cfg.n_layers - 1
            self.mtp_proj = Dense(2 * cfg.d_model, cfg.d_model, dtype=dtype,
                                  device=device)
            self.mtp_layer = nn.ModuleList([Layer(
                cfg, _mixer_kind(cfg, last), 0, cfg.is_moe_layer(last),
                dtype=dtype, device=device)])

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
        axis of 0, as JAX's scan over no blocks does."""
        new_caches = []
        for si, seg in enumerate(self.segments):
            outs: List[List[Dict[str, Any]]] = [[] for _ in seg.kinds]
            for c, block in enumerate(self._blocks(si)):
                for i, layer in enumerate(block):
                    ci = None if caches is None else _tree_map(
                        lambda t: t[c], caches[si][i])
                    x, nc = layer(x, cfg=self.cfg, mode=mode, cache=ci,
                                  pos=pos, memory=memory)
                    if sink is None:
                        outs[i].append(nc)
                    else:
                        sink(si, i, c, nc)
            if sink is not None:
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
        return x, (None if sink is not None else new_caches)

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
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return self.embed[tokens.long()]

    def _encode(self, src_embeds) -> torch.Tensor:
        """The encoder over the source embeddings [B, S, d]: bidirectional
        attention and the SwiGLU in each layer, then ``enc_ln_f``."""
        x = torch.as_tensor(src_embeds, device=self.device).to(self.dtype)
        for layer in self.encoder:
            x, _ = layer(x, cfg=self.cfg, mode="encode")
        return self.enc_ln_f(x, self.cfg.norm_eps)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_f(x, self.cfg.norm_eps)
        logits = x @ self.embed.T if self.unembed is None else self.unembed(x)
        if self.vocab_padded != self.cfg.vocab:
            iota = torch.arange(self.vocab_padded, device=logits.device)
            logits = torch.where(iota < self.cfg.vocab, logits,
                                 torch.full_like(logits, -1e30))
        return logits

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
            else self.embed[tok.long()]
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
                entry = {"mix": {n: zeros((S, cfg.n_kv, dims.hd), kv_dtype)
                                 for n in ("k", "v")}}
            if cfg.enc_layers and src_len:
                for n in ("xk", "xv"):
                    entry[n] = zeros((src_len, dims.n_kv, dims.hd), kv_dtype)
            return entry

        return [one(kind, window) for kind, _, window in seg.kinds]


def build_model(cfg: ArchConfig, *, device=None, dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None) -> Model:
    """Build on ``device`` (default: the card; raises without one). With a
    ``generator`` the weights are drawn from it; otherwise they are zero
    until :meth:`Model.init` or a ``load_state_dict``."""
    model = Model(cfg, dtype=dtype, device=resolve_device(device))
    if generator is not None:
        model.init(generator)
    return model
