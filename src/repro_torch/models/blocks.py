"""Decoder blocks: GQA attention, the SwiGLU FFN and the Mamba2 (SSD)
mixer.

``attn_apply`` has the JAX package's serving modes:
  * ``prefill`` — full-sequence causal; with ``cache`` a *suffix* prefill
    over a reused prefix (the query starts at ``q_offset = Pk``);
  * ``decode``  — one token per sequence against a fixed-capacity cache,
    each sequence at its own position (``pos`` is a [B] tensor): the new
    K/V are written in place at each sequence's position and attention
    runs with ``lengths = pos + 1``.
int8 KV and sliding-window / ring-buffer masks wait for the slices whose
models need them. ``ssd_apply`` has the same three modes over a per-sequence
``{"conv", "state"}`` cache (see its docstring).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from .layers import Dense, RMSNorm, SwiGLU, apply_rope, normal_, rmsnorm, rope
from .sharding import HEAD_PAD, pad_to_multiple

__all__ = ["AttnDims", "Attention", "attn_init", "attn_apply", "ffn_init",
           "ffn_apply", "SSD", "ssd_init", "ssd_apply"]


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
    W = cfg.ssm_conv
    zxbcdt = p.w_in(x)
    z = zxbcdt[..., :d_in]
    conv_in = zxbcdt[..., d_in:2 * d_in + 2 * N]          # [x, B, C]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    if cache is not None:
        prev = cache["conv"]
    else:
        prev = torch.zeros((B, W - 1, conv_in.shape[-1]), dtype=conv_in.dtype,
                           device=x.device)
    window = torch.cat([prev, conv_in], 1)                # [B, W-1+T, C]
    new_conv = window[:, T:]                              # last W-1 steps
    taps = p.conv.float()                                 # [W, C]
    win = window.float()
    acc = win[:, 0:T] * taps[0]
    for w in range(1, W):
        acc = acc + win[:, w:w + T] * taps[w]
    conv_out = F.silu(acc)
    xh = conv_out[..., :d_in].reshape(B, T, H, hd)
    Bc = conv_out[..., d_in:d_in + N]
    Cc = conv_out[..., d_in + N:]
    A = -torch.exp(p.A_log)
    dt_s = F.softplus(dt.float() + p.dt_bias)
    y, state = kops.ssd(xh, Bc, Cc, dt_s, A, p.D,
                        init_state=None if cache is None else cache["state"])
    y = y.reshape(B, T, d_in).to(x.dtype)
    y = rmsnorm(p.norm.g, y * F.silu(z))
    out = p.w_out(y)
    if mode == "decode":
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)
        return out, cache
    return out, {"conv": new_conv, "state": state}
