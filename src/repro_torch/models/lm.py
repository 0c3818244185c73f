"""Model assembly for the dense decoder family: embedding, ``count``
decoder layers per segment, final norm and tied unembedding.

Public API, in the JAX package's layouts (``Model`` of ``repro.models.lm``):
  init(generator)                      -> fills the parameters in place
  prefill(batch, caches=None, pos=0)   -> (logits_last [B,1,Vp], caches)
  decode_step(caches, tok, pos)        -> (logits [B,1,Vp], caches)
  init_cache(batch_size, max_len)      -> zero caches

The cache keeps the JAX nesting: a list per segment, a list per sublayer,
then ``{"mix": {"k", "v"}}`` of ``[count, B, S, n_kv, hd]``. ``decode_step``
writes the new tokens into the caches it is given, in place, and returns
them; ``prefill`` builds new ones. ``pos`` of ``decode_step`` is an int or a
[B] tensor of per-sequence positions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from .blocks import AttnDims, attn_apply, attn_init, ffn_apply, ffn_init
from .layers import RMSNorm, normal_
from .sharding import HEAD_PAD, pad_to_multiple

__all__ = ["Model", "build_model", "Segment", "plan_segments"]


@dataclass(frozen=True)
class Segment:
    """``count`` repetitions of the sublayer pattern ``kinds``; each entry is
    (mixer_kind, is_moe, window)."""

    count: int
    kinds: Tuple[Tuple[str, bool, int], ...]


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    """One segment of ``n_layers`` attention layers: the plan of a dense
    model. Other families come with their slices."""
    _check_supported(cfg)
    return [Segment(cfg.n_layers, (("attn", False, cfg.window),))]


def _check_supported(cfg: ArchConfig) -> None:
    unsupported = {
        "family": cfg.family != "dense", "block_pattern": bool(cfg.block_pattern),
        "n_experts": bool(cfg.n_experts), "use_mla": cfg.use_mla,
        "enc_layers": bool(cfg.enc_layers), "window": bool(cfg.window),
        "mtp": bool(cfg.mtp), "tie_embeddings": not cfg.tie_embeddings}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense full-attention decoders so "
            f"far; unsupported fields: {bad}")


class Layer(nn.Module):
    """rmsnorm -> attention -> residual -> rmsnorm -> SwiGLU -> residual."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.mix = attn_init(cfg, dtype=dtype, device=device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = ffn_init(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.mix, self.ln2, self.ffn):
            m.init(generator)

    def forward(self, x, *, cfg: ArchConfig, mode: str, cache=None, pos=0):
        h, mix_cache = attn_apply(self.mix, self.ln1(x, cfg.norm_eps),
                                  cfg=cfg, mode=mode, cache=cache, pos=pos)
        x = x + h
        x = x + ffn_apply(self.ffn, self.ln2(x, cfg.norm_eps))
        return x, mix_cache


class Model(nn.Module):
    """Dense causal LM. Parameters are ``embed`` [Vp, d], ``ln_f`` and one
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
        for si, seg in enumerate(self.segments):
            self.add_module(f"seg{si}", nn.ModuleList(
                nn.ModuleList(Layer(cfg, dtype=dtype, device=device)
                              for _ in seg.kinds)
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
        logits = x @ self.embed.T
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
        """Zero caches storing the REAL kv-head count, in the model's dtype
        (which the decode kernel requires; int8 KV comes with its slice)."""
        dims = AttnDims.of(self.cfg)
        shape = (batch_size, max_len, self.cfg.n_kv, dims.hd)
        return [[{"mix": {n: torch.zeros((seg.count,) + shape,
                                         dtype=self.dtype, device=self.device)
                          for n in ("k", "v")}}
                 for _ in seg.kinds] for seg in self.segments]


def build_model(cfg: ArchConfig, *, device=None, dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None) -> Model:
    """Build on ``device`` (default: the card; raises without one). With a
    ``generator`` the weights are drawn from it; otherwise they are zero
    until :meth:`Model.init` or a ``load_state_dict``."""
    model = Model(cfg, dtype=dtype, device=resolve_device(device))
    if generator is not None:
        model.init(generator)
    return model
