"""Decoder blocks: GQA attention (full or local), the SwiGLU FFN, the
mixture-of-experts FFN (routed and shared experts), the Mamba2 (SSD) mixer
and the RG-LRU recurrent block of RecurrentGemma.

``attn_apply`` has the JAX package's serving modes:
  * ``prefill`` — full-sequence causal; with ``cache`` a *suffix* prefill
    over a reused prefix (the query starts at ``q_offset = Pk``);
  * ``decode``  — one token per sequence against a fixed-capacity cache,
    each sequence at its own position (``pos`` is a [B] tensor): the new
    K/V are written in place at each sequence's position and attention
    runs with ``lengths = pos + 1``.
A local-attention layer (``window > 0``) masks keys ``window`` or more
positions back, keeps only the last ``window`` positions in its prefill
cache and decodes into a ring buffer (see ``attn_apply``). int8 KV waits
for the slice whose model needs it. ``ssd_apply`` and ``rglru_apply`` have
the same three modes over a per-sequence ``{"conv", "state"}`` cache (see
``ssd_apply``'s docstring). ``moe_apply`` is the JAX package's
single-device MoE: tokens sorted by expert through grouped products for a
prefill, each token through its experts' gathered weights for decode.
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
           "ffn_apply", "MoE", "moe_init", "moe_apply", "SSD", "ssd_init",
           "ssd_apply", "RGLRU", "rglru_init", "rglru_apply"]


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
        # the q->kv map the attention kernels read, int32 on the model's
        # device: made once, never converted or copied per call
        self.register_buffer("kv_map", dims.q_to_kv(cfg).to(
            device=device, dtype=torch.int32), persistent=False)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.init(generator)
        # zero the padded query heads' output rows => exact no-op heads
        self.wo.w[self.real_rows:] = 0.0


def attn_init(cfg: ArchConfig, *, dtype=torch.bfloat16,
              device=None) -> Attention:
    return Attention(cfg, dtype=dtype, device=device)


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
    MHA model that keeps only the real heads."""
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

    if mode == "decode":
        assert cache is not None and T == 1
        ck, cv = cache["k"], cache["v"]                      # [B,S,n_store,hd]
        S, n_store = ck.shape[1], ck.shape[2]
        # written in place: a local layer at pos % S of its ring; a full
        # one at pos, a position past the capacity clamped to the last slot,
        # as JAX's dynamic_update_slice does, so dead slots stay inside
        slot = pos % S if window else pos.clamp(max=S - 1)
        rows = torch.arange(B, device=x.device)
        ck[rows, slot] = k[:, 0, :n_store].to(ck.dtype)
        cv[rows, slot] = v[:, 0, :n_store].to(cv.dtype)
        lengths = (pos + 1).clamp(max=S)
        out = kops.decode_attention(q[:, 0], ck, cv, lengths,
                                    kv_map=p.kv_map)[:, None]
        new_cache = {"k": ck, "v": cv}
    elif cache is not None:
        # suffix prefill over a reused prefix holding positions [pos-Pk, pos):
        # masks depend only on position differences, so q_offset = Pk
        Pk = cache["k"].shape[1]
        k_all = torch.cat([cache["k"], k], 1)
        v_all = torch.cat([cache["v"], v], 1)
        out = kops.attention(q, k_all, v_all, causal=True, q_offset=Pk,
                             window=window, kv_map=p.kv_map)
        keep = min(window, Pk + T) if window else Pk + T
        new_cache = {"k": k_all[:, -keep:], "v": v_all[:, -keep:]}
    else:
        out = kops.attention(q, k, v, causal=True, window=window,
                             kv_map=p.kv_map)
        keep = min(window, T) if window else T
        new_cache = {"k": k[:, T - keep:], "v": v[:, T - keep:]}
    y = p.wo(out.reshape(B, T, dims.n_q * dims.hd))
    return y, new_cache


# ---------------------------------------------------------------- dense FFN
def ffn_init(cfg: ArchConfig, d_ff: Optional[int] = None, *,
             dtype=torch.bfloat16, device=None) -> SwiGLU:
    return SwiGLU(cfg.d_model, d_ff or cfg.d_ff, dtype=dtype, device=device)


def ffn_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return p(x)


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
        expert outputs, the shared SwiGLU as a dense one."""
        d, F_ = self.w_in.shape[1], self.w_in.shape[2]
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


def _expert_ffn(w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor,
                x: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert, the function of JAX's
    ``ragged_dot``: row ``r`` of ``x`` goes through expert ``expert[r]``
    (non-decreasing). Each group is laid at the front of its expert's slot
    of an ``[E, C, d]`` buffer, C the largest group, and the three products
    run batched over the experts, each expert's weights read once; the zero
    rows past a group are never read back.

    C is read on the host, one synchronisation a call: the buffer is sized
    by it. The group offsets come from a search over the sorted ids (JAX's
    ``bincount`` group sizes, as offsets), which needs no host read of the
    ids' range as ``torch.bincount`` makes on the card."""
    E, D = w_in.shape[0], x.shape[-1]
    bounds = torch.searchsorted(expert, torch.arange(
        E + 1, device=x.device, dtype=expert.dtype))
    C = int((bounds[1:] - bounds[:-1]).max())
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


def moe_apply(p: MoE, x: torch.Tensor, *, cfg: ArchConfig, mode: str
              ) -> torch.Tensor:
    """x: [B, T, D]. The token gather for decode, the sorted grouped
    products otherwise, plus the shared experts."""
    local = _moe_token_gather if mode == "decode" else _moe_local
    y = local(p, x, cfg)
    if p.shared is not None:
        y = y + p.shared(x)
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
    x's dtype: the window the next call resumes from)."""
    B, T, C = x.shape
    W = taps.shape[0]
    if prev is None:
        prev = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    seq = torch.cat([prev, x], 1)                         # [B, W-1+T, C]
    t, s = taps.float(), seq.float()
    y = s[:, 0:T] * t[0]
    for i in range(1, W):
        y = y + s[:, i:i + T] * t[i]
    return y, seq[:, T:]


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
    return out, {"conv": new_conv, "state": state}


# -------------------------------------------------- RG-LRU (RecurrentGemma)
_RGLRU_BLOCKS = 16      # Griffin's block-diagonal gate heads
_RGLRU_C = 8.0          # a = sigmoid-gated power of Lambda: exp(-c r softplus)


class RGLRU(nn.Module):
    """Griffin recurrent block parameters, named as the JAX ``rglru_init``
    pytree: branch and gate projections ``w_x``/``w_gate_branch``
    ``[d, w]``, the temporal conv taps ``[ssm_conv, w]``, the block-diagonal
    gates ``gate_in``/``gate_rec`` ``[nb, w/nb, w/nb]``, the per-channel
    decay ``a_param`` (float32 in any model dtype) and ``w_out_rg``."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru_width or d
        nb = _RGLRU_BLOCKS if w % _RGLRU_BLOCKS == 0 else 1
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

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 1/d_in) projections, N(0, 0.2^2) conv taps,
        N(0, 1/kb) gates, and Lambda = linspace(0.9, 0.999, w) as
        ``a_param = log(expm1(Lambda^(1/c)))``."""
        self.w_x.init(generator)
        self.w_gate_branch.init(generator)
        normal_(self.conv, generator, 0.2)
        kb = self.gate_in.shape[1]
        normal_(self.gate_in, generator, kb ** -0.5)
        normal_(self.gate_rec, generator, kb ** -0.5)
        lam = torch.linspace(0.9, 0.999, self.a_param.numel(),
                             dtype=torch.float32)
        self.a_param.copy_(torch.log(torch.expm1(lam ** (1.0 / _RGLRU_C))))
        self.w_out_rg.init(generator)


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
    """
    B, T, _ = x.shape
    w = p.a_param.numel()
    gate_branch = F.gelu(p.w_gate_branch(x), approximate="tanh")
    xt, new_conv = _causal_conv(p.w_x(x), p.conv,
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
    if mode == "decode":
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)
        return y, cache
    return y, {"conv": new_conv, "state": state}
