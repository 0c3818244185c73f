"""Dense decoder blocks: GQA attention and the SwiGLU FFN.

``attn_apply`` has the JAX package's serving modes:
  * ``prefill`` — full-sequence causal; with ``cache`` a *suffix* prefill
    over a reused prefix (the query starts at ``q_offset = Pk``);
  * ``decode``  — one token per sequence against a fixed-capacity cache,
    each sequence at its own position (``pos`` is a [B] tensor): the new
    K/V are written in place at each sequence's position and attention
    runs with ``lengths = pos + 1``.
int8 KV and sliding-window / ring-buffer masks wait for the slices whose
models need them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from .layers import Dense, SwiGLU, apply_rope, rope
from .sharding import HEAD_PAD, pad_to_multiple

__all__ = ["AttnDims", "Attention", "attn_init", "attn_apply", "ffn_init",
           "ffn_apply"]


@dataclass(frozen=True)
class AttnDims:
    """Padded head layout: query heads pad to a multiple of ``HEAD_PAD``
    (the padded heads are exact no-ops through zeroed ``wo`` rows). KV heads
    keep their true count unless the model is MHA, where they pad alongside
    the query heads."""

    n_q: int           # padded query heads
    n_kv: int          # stored kv heads (== n_q when MHA)
    hd: int

    @staticmethod
    def of(cfg: ArchConfig) -> "AttnDims":
        n_q = pad_to_multiple(cfg.n_heads, HEAD_PAD)
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
        # the q->kv map lives on the model's device: no copy per call
        self.register_buffer("qmap", dims.q_to_kv(cfg).to(device),
                             persistent=False)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.init(generator)
        # zero the padded query heads' output rows => exact no-op heads
        self.wo.w[self.real_rows:] = 0.0


def attn_init(cfg: ArchConfig, *, dtype=torch.bfloat16,
              device=None) -> Attention:
    return Attention(cfg, dtype=dtype, device=device)


def _expand_kv(x: torch.Tensor, qmap: torch.Tensor, n_kv: int
               ) -> torch.Tensor:
    """[B,S,n_store,hd] -> [B,S,n_q,hd] through the static q->kv map
    (``n_kv`` heads), clamped to the stored heads (a decode cache of an MHA
    model keeps only the real heads). One kv head (MQA) expands as a
    stride-0 view; otherwise the heads are copied."""
    n_store = x.shape[2]
    if n_store == qmap.numel():
        return x
    if n_store == 1:
        return x.expand(-1, -1, qmap.numel(), -1)
    if n_store < n_kv:
        qmap = qmap.clamp(max=n_store - 1)
    return x.index_select(2, qmap)


def attn_apply(p: Attention, x: torch.Tensor, *, cfg: ArchConfig, mode: str,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Union[int, torch.Tensor] = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D]. Returns (y, new_cache)."""
    B, T, _ = x.shape
    dims = AttnDims.of(cfg)
    q = p.wq(x).reshape(B, T, dims.n_q, dims.hd)
    k = p.wk(x).reshape(B, T, dims.n_kv, dims.hd)
    v = p.wv(x).reshape(B, T, dims.n_kv, dims.hd)
    if mode == "decode":
        positions = pos.reshape(B, 1)                          # [B, 1]
    else:
        positions = pos + torch.arange(T, device=x.device)[None, :]
    sin, cos = rope(positions, dims.hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    def expand(t):
        return _expand_kv(t, p.qmap, dims.n_kv)

    if mode == "decode":
        assert cache is not None and T == 1
        ck, cv = cache["k"], cache["v"]                        # [B,S,n_kv,hd]
        S, n_store = ck.shape[1], ck.shape[2]
        # written in place; a position past the capacity clamps to the last
        # slot, as JAX's dynamic_update_slice does, so dead slots stay inside
        slot = pos.clamp(max=S - 1)
        rows = torch.arange(B, device=x.device)
        ck[rows, slot] = k[:, 0, :n_store].to(ck.dtype)
        cv[rows, slot] = v[:, 0, :n_store].to(cv.dtype)
        lengths = (pos + 1).clamp(max=S)
        out = kops.decode_attention(q[:, 0], expand(ck), expand(cv),
                                    lengths)[:, None]
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        # suffix prefill over a reused prefix holding positions [pos-Pk, pos):
        # masks depend only on position differences, so q_offset = Pk
        Pk = cache["k"].shape[1]
        k_all = torch.cat([cache["k"], k], 1)
        v_all = torch.cat([cache["v"], v], 1)
        new_cache = {"k": k_all, "v": v_all}
        out = kops.attention(q, expand(k_all), expand(v_all), causal=True,
                             q_offset=Pk)
    else:
        new_cache = {"k": k, "v": v}
        out = kops.attention(q, expand(k), expand(v), causal=True)
    y = p.wo(out.reshape(B, T, dims.n_q * dims.hd))
    return y, new_cache


# ---------------------------------------------------------------- dense FFN
def ffn_init(cfg: ArchConfig, d_ff: Optional[int] = None, *,
             dtype=torch.bfloat16, device=None) -> SwiGLU:
    return SwiGLU(cfg.d_model, d_ff or cfg.d_ff, dtype=dtype, device=device)


def ffn_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return p(x)
