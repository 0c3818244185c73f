"""Model assembly for the dense decoder, the mixture of experts (DeepSeek
style: ``first_dense`` dense layers, then MoE layers), the attention-free
SSM (Mamba2) and the hybrid (RecurrentGemma: RG-LRU blocks and local
attention) families: embedding, ``count`` blocks of sublayers per segment,
final norm and the unembedding (tied to the embedding, or its own
``unembed``).

Public API, in the JAX package's layouts (``Model`` of ``repro.models.lm``):
  init(generator)                      -> fills the parameters in place
  prefill(batch, caches=None, pos=0)   -> (logits_last [B,1,Vp], caches)
  decode_step(caches, tok, pos)        -> (logits [B,1,Vp], caches)
  init_cache(batch_size, max_len)      -> zero caches

The cache keeps the JAX nesting: a list per segment, a list per sublayer,
then ``{"mix": {...}}`` with a leading ``count`` axis: ``{"k", "v"}`` of
``[count, B, S, n_kv, hd]`` for attention (``S <= window`` for a local
layer), ``{"conv": [count, B, W-1, d_in+2N], "state": [count, B, H, hd, N]
float32}`` for the SSM and ``{"conv": [count, B, W-1, w], "state": [count,
B, w] float32}`` for an RG-LRU block.
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
from .blocks import (AttnDims, attn_apply, attn_init, ffn_apply, ffn_init,
                     moe_apply, moe_init, rglru_apply, rglru_init, ssd_apply,
                     ssd_init)
from .layers import Dense, RMSNorm, normal_
from .sharding import HEAD_PAD, pad_to_multiple

__all__ = ["Model", "build_model", "Segment", "plan_segments"]


@dataclass(frozen=True)
class Segment:
    """``count`` repetitions of the sublayer pattern ``kinds``; each entry is
    (mixer_kind, is_moe, window)."""

    count: int
    kinds: Tuple[Tuple[str, bool, int], ...]


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    """As the JAX ``plan_segments``: a hybrid repeats its ``block_pattern``
    unit ``n_layers // len(pattern)`` times, then a tail segment of the
    remaining sublayers, with the window on the attention sublayers only;
    a mixture of experts with ``first_dense`` layers is a dense segment of
    those and an MoE segment of the rest; any other model is one segment
    of ``n_layers`` layers (MoE when it has experts)."""
    _check_supported(cfg)
    if cfg.block_pattern:
        def kinds(n):
            return tuple((cfg.layer_kind(i), False,
                          cfg.window if cfg.layer_kind(i) == "attn" else 0)
                         for i in range(n))
        n_units, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
        segs = [Segment(n_units, kinds(len(cfg.block_pattern)))] \
            if n_units else []
        return segs + ([Segment(1, kinds(rem))] if rem else [])
    kind, w = cfg.layer_kind(0), cfg.window
    if cfg.n_experts and cfg.first_dense:
        return [Segment(cfg.first_dense, ((kind, False, w),)),
                Segment(cfg.n_layers - cfg.first_dense, ((kind, True, w),))]
    return [Segment(cfg.n_layers, ((kind, cfg.n_experts > 0, w),))]


def _check_supported(cfg: ArchConfig) -> None:
    unsupported = {
        "family": cfg.family not in ("dense", "moe", "ssm", "hybrid"),
        "use_mla": cfg.use_mla, "enc_layers": bool(cfg.enc_layers),
        "mtp": bool(cfg.mtp)}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense decoders, mixtures of "
            f"experts, SSMs and hybrids so far; unsupported fields: {bad}")


_MIXER_INIT = {"attn": attn_init, "ssm": ssd_init, "rec": rglru_init}


class Layer(nn.Module):
    """Attention or RG-LRU (``rec``): rmsnorm -> mixer -> residual ->
    rmsnorm -> FFN -> residual, the FFN a SwiGLU (``ffn``) or, with
    ``is_moe``, the experts (``ffn_moe``, the JAX pytree's name). SSM
    (Mamba2): rmsnorm -> SSD mixer -> residual, no FFN. ``window`` is the
    local-attention window of an attention sublayer (0: full)."""

    def __init__(self, cfg: ArchConfig, kind: str, window: int = 0,
                 is_moe: bool = False, *, dtype, device):
        super().__init__()
        self.kind, self.window = kind, window
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.mix = _MIXER_INIT[kind](cfg, dtype=dtype, device=device)
        self.ln2 = self.ffn = self.ffn_moe = None
        if kind != "ssm":
            self.ln2 = RMSNorm(cfg.d_model, device=device)
            if is_moe:
                self.ffn_moe = moe_init(cfg, dtype=dtype, device=device)
            else:
                self.ffn = ffn_init(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.mix, self.ln2, self.ffn, self.ffn_moe):
            if m is not None:
                m.init(generator)

    def forward(self, x, *, cfg: ArchConfig, mode: str, cache=None, pos=0):
        h = self.ln1(x, cfg.norm_eps)
        if self.kind == "ssm":
            h, mix_cache = ssd_apply(self.mix, h, cfg=cfg, mode=mode,
                                     cache=cache)
            return x + h, mix_cache
        if self.kind == "rec":
            h, mix_cache = rglru_apply(self.mix, h, cfg=cfg, mode=mode,
                                       cache=cache)
        else:
            h, mix_cache = attn_apply(self.mix, h, cfg=cfg, mode=mode,
                                      cache=cache, pos=pos,
                                      window=self.window)
        x = x + h
        h = self.ln2(x, cfg.norm_eps)
        if self.ffn_moe is not None:
            return x + moe_apply(self.ffn_moe, h, cfg=cfg, mode=mode), \
                mix_cache
        return x + ffn_apply(self.ffn, h), mix_cache


class Model(nn.Module):
    """Causal LM: dense, MoE, SSM or hybrid. Parameters are ``embed`` [Vp, d],
    ``ln_f``, ``unembed`` [d, Vp] when the embeddings are not tied, and one
    ``seg{i}`` ModuleList per segment holding ``count`` blocks of sublayers
    (the JAX pytree's ``vmap``-stacked ``count`` axis, unstacked)."""

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
                nn.ModuleList(Layer(cfg, kind, window, is_moe, dtype=dtype,
                                    device=device)
                              for kind, is_moe, window in seg.kinds)
                for _ in range(seg.count)))

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
        self.ln_f.init(generator)
        if self.unembed is not None:
            self.unembed.init(generator)
        for si in range(len(self.segments)):
            for block in self._blocks(si):
                for layer in block:
                    layer.init(generator)
        return self

    # ------------------------------------------------------------- backbone
    def _blocks(self, si: int) -> nn.ModuleList:
        return getattr(self, f"seg{si}")

    def _run_segments(self, x, mode: str, caches=None, pos=0):
        """Returns (x, caches: list per segment). Decode writes into the
        given caches and returns them."""
        new_caches = []
        for si, seg in enumerate(self.segments):
            outs: List[List[Dict[str, torch.Tensor]]] = [[] for _ in seg.kinds]
            for c, block in enumerate(self._blocks(si)):
                for i, layer in enumerate(block):
                    ci = None
                    if caches is not None:
                        ci = {n: t[c] for n, t in caches[si][i]["mix"].items()}
                    x, nc = layer(x, cfg=self.cfg, mode=mode, cache=ci,
                                  pos=pos)
                    outs[i].append(nc)
            if mode == "decode":
                new_caches.append(caches[si])
            else:
                new_caches.append([
                    {"mix": {n: torch.stack([o[n] for o in per_layer])
                             for n in per_layer[0]}}
                    for per_layer in outs])
        return x, new_caches

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
    def prefill(self, batch: Dict[str, Any], caches=None, pos: int = 0):
        """Full prefill, or *suffix* prefill resuming from a reused prefix
        cache (``caches`` from a prefill of the first ``pos`` tokens)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = self.embed[tokens.long()]
        x, caches = self._run_segments(x, "prefill", caches=caches,
                                       pos=int(pos))
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, caches, tok, pos: Union[int, torch.Tensor]):
        """tok: [B, 1] int; pos: int or [B] positions (== current lengths)."""
        tok = torch.as_tensor(tok, device=self.device).long()
        B = tok.shape[0]
        pos = torch.as_tensor(pos, device=self.device).long().expand(B)
        x = self.embed[tok]
        x, caches = self._run_segments(x, "decode", caches=caches, pos=pos)
        return self._logits(x), caches

    # ---------------------------------------------------------- cache specs
    def init_cache(self, batch_size: int, max_len: int):
        """Zero caches. Attention stores the REAL kv-head count, in the
        model's dtype (which the decode kernel requires; int8 KV comes with
        its slice), over ``min(max_len, window)`` slots for a local layer;
        the SSM and RG-LRU blocks store their conv window in the model's
        dtype and their state in float32."""
        cfg = self.cfg

        def zeros(count, shape, dtype=self.dtype):
            return torch.zeros((count, batch_size) + shape, dtype=dtype,
                               device=self.device)

        def one(kind, window, count):
            if kind == "ssm":
                d_in = cfg.ssm_expand * cfg.d_model
                H, N = d_in // cfg.ssm_head_dim, cfg.ssm_state
                return {"mix": {
                    "conv": zeros(count, (cfg.ssm_conv - 1, d_in + 2 * N)),
                    "state": zeros(count, (H, cfg.ssm_head_dim, N),
                                   torch.float32)}}
            if kind == "rec":
                w = cfg.rglru_width or cfg.d_model
                return {"mix": {
                    "conv": zeros(count, (cfg.ssm_conv - 1, w)),
                    "state": zeros(count, (w,), torch.float32)}}
            S = min(max_len, window) if window else max_len
            shape = (S, cfg.n_kv, AttnDims.of(cfg).hd)
            return {"mix": {n: zeros(count, shape) for n in ("k", "v")}}

        return [[one(kind, window, seg.count) for kind, _, window in seg.kinds]
                for seg in self.segments]


def build_model(cfg: ArchConfig, *, device=None, dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None) -> Model:
    """Build on ``device`` (default: the card; raises without one). With a
    ``generator`` the weights are drawn from it; otherwise they are zero
    until :meth:`Model.init` or a ``load_state_dict``."""
    model = Model(cfg, dtype=dtype, device=resolve_device(device))
    if generator is not None:
        model.init(generator)
    return model
