"""DeepSeek-V3's decoder as published, plainly, over one chip's share of
its experts.

Pre-norm layers: RMSNorm, multi-head latent attention (MLA), residual,
RMSNorm, then a gated MLP (the first ``first_k_dense_replace`` layers) or
the experts, residual; then RMSNorm and the unembedding. Attention is the
published non-absorbed form: the query through its low-rank bottleneck
(``wq_a``, ``q_norm``, ``wq_b``: ``qk_nope_head_dim`` + ``qk_rope_head_dim``
a head), the latent ``c = kv_norm((x @ wkv_a)[:kv_lora_rank])`` and one
shared rope key from the rest, every head's K and V from the latent's
up-projection ``wkv_b`` (``qk_nope_head_dim`` then ``v_head_dim`` a head),
RoPE on the rope dims in the published interleaved pairing (dims 2j and
2j + 1 turn together) with YaRN's frequencies, and scores scaled by
``(nope + rope)^-1/2`` times YaRN's ``mscale_all_dim`` factor squared.

The experts: sigmoid scores of ``x @ router`` over every published expert,
a bias added for the choice only, a group's score the sum of its two best
biased scores, the ``topk_group`` best of ``n_group`` groups kept, the
``num_experts_per_tok`` best biased scores among their experts chosen, each
gate the chosen expert's unbiased score over the chosen ones' sum times
``routed_scaling_factor``. Of the routed experts only those this chip
holds (``held_first`` on, ``n_routed_experts`` of them) add their gated
SwiGLU; the shared expert's SwiGLU is added to every token.

Every product is float32 with TF32 off (``dense.exact``). With
``precision="fp8"`` each operand of each product is rounded to float8_e4m3
first, one scale a tensor: the control, one precision below the bf16 the
configuration serves in. Attention runs in blocks of query positions and
heads, one layer's leaves in float32 at a time, so that 8k positions fit
beside the weights. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from .dense import _mm, rmsnorm

Q_BLOCK = 1024          # query positions a score block holds
HEAD_BLOCK = 16         # heads a score block holds


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_bounds(cfg: Dict[str, Any]):
    """(low, high): the rope dims where YaRN's ramp starts and ends, from
    the published ``beta_fast`` and ``beta_slow`` turns over the original
    context."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], \
        cfg["rope_theta"]

    def at(turns):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (turns * 2 * math.pi))
                / (2 * math.log(base)))
    return (max(math.floor(at(rs["beta_fast"])), 0),
            min(math.ceil(at(rs["beta_slow"])), dim - 1))


def yarn_freqs(cfg: Dict[str, Any], device=None) -> torch.Tensor:
    """The ``qk_rope_head_dim / 2`` frequencies: the base's for dims below
    ``low``, over ``factor`` above ``high``, a linear ramp between."""
    rs, dim = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    extra = 1.0 / cfg["rope_theta"] ** (2 * i / dim)
    low, high = yarn_bounds(cfg)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(cfg: Dict[str, Any]) -> float:
    rs = cfg["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope(x: torch.Tensor, pos: torch.Tensor, cfg: Dict[str, Any]
         ) -> torch.Tensor:
    """x [T, H, D] at positions ``pos`` [T], pairs (2j, 2j + 1) turned by
    frequency j; YaRN's table scale (1 for DeepSeek-V3) applied."""
    rs = cfg["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"],
                                                      rs["mscale_all_dim"])
    ang = pos.float()[:, None] * yarn_freqs(cfg, x.device)     # [T, D/2]
    c, s = (torch.cos(ang) * m)[:, None], (torch.sin(ang) * m)[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, a * s + b * c], -1).flatten(-2)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor],
              cfg: Dict[str, Any], pos: torch.Tensor, precision: str
              ) -> torch.Tensor:
    """MLA over x [T, d] at positions ``pos``, causal."""
    T = x.shape[0]
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = _mm(rmsnorm(_mm(x, w["wq_a"], precision), w["q_norm"], eps),
            w["wq_b"], precision).view(T, H, dn + dr)
    kv = _mm(x, w["wkv_a"], precision)
    c = rmsnorm(kv[:, :r], w["kv_norm"], eps)
    k_pe = rope(kv[:, None, r:], pos, cfg)                      # [T, 1, dr]
    q_pe = rope(q[..., dn:], pos, cfg)
    kvb = _mm(c, w["wkv_b"], precision).view(T, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe.expand(T, H, dr)], -1)  # [T, H, 192]
    qf = torch.cat([q[..., :dn], q_pe], -1)
    v = kvb[..., dn:]
    scale = softmax_scale(cfg)
    out = torch.empty(T, H, dv, device=x.device)
    for q0 in range(0, T, Q_BLOCK):
        q1 = min(T, q0 + Q_BLOCK)
        mask = pos[None, :q1] <= pos[q0:q1, None]               # [t, s]
        for h0 in range(0, H, HEAD_BLOCK):
            h1 = min(H, h0 + HEAD_BLOCK)
            qh = qf[q0:q1, h0:h1].transpose(0, 1)               # [h, t, 192]
            kh = k[:q1, h0:h1].transpose(0, 1)
            s = _mm(qh, kh.transpose(-1, -2), precision) * scale
            s = s.masked_fill(~mask, float("-inf"))
            out[q0:q1, h0:h1] = _mm(torch.softmax(s, -1),
                                    v[:q1, h0:h1].transpose(0, 1),
                                    precision).transpose(0, 1)
    return _mm(out.reshape(T, H * dv), w["wo"], precision)


def swiglu(x, wg, wi, wd, precision):
    return _mm(F.silu(_mm(x, wg, precision)) * _mm(x, wi, precision), wd,
               precision)


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          cfg: Dict[str, Any], precision: str = "f32"):
    """(gates [T, k], chosen experts [T, k]) of the published router."""
    scores = torch.sigmoid(_mm(x, router, precision))
    biased = scores + bias
    T, E = biased.shape
    G, kg = cfg["n_group"], cfg["topk_group"]
    per = biased.view(T, G, E // G)
    best = per.topk(2, -1).values.sum(-1).topk(kg, -1).indices
    keep = torch.zeros(T, G, dtype=torch.bool, device=x.device)
    keep[torch.arange(T, device=x.device)[:, None], best] = True
    masked = per.masked_fill(~keep[..., None], float("-inf")).view(T, E)
    idx = masked.topk(cfg["num_experts_per_tok"], -1).indices
    gates = scores.gather(1, idx)
    return gates / gates.sum(-1, keepdim=True) \
        * cfg["routed_scaling_factor"], idx


def experts(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict[str, Any],
            precision: str) -> torch.Tensor:
    """The held experts' share and the shared expert, over x [T, d]."""
    gates, idx = route(x, w["router"], w["router_bias"], cfg, precision)
    y = swiglu(x, w["ws_g"], w["ws_i"], w["ws_d"], precision)
    lo = cfg["held_first"]
    for e in range(cfg["n_routed_experts"]):
        rows, k = torch.nonzero(idx == lo + e, as_tuple=True)
        if rows.numel():
            out = swiglu(x[rows], w["we_g"][e], w["we_i"][e], w["we_d"][e],
                         precision)
            y = y.index_add(0, rows, out * gates[rows, k][:, None])
    return y


DENSE_LEAVES = ("wg", "wi", "wd")
MOE_LEAVES = ("router", "router_bias", "we_g", "we_i", "we_d", "ws_g",
              "ws_i", "ws_d")
ATTN_LEAVES = ("ln1", "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b",
               "wo", "ln2")


def is_moe(cfg: Dict[str, Any], i: int) -> bool:
    return i >= cfg["first_k_dense_replace"]


def layer_leaves(leaves: Dict[str, torch.Tensor], cfg: Dict[str, Any],
                 i: int) -> Dict[str, torch.Tensor]:
    names = ATTN_LEAVES + (MOE_LEAVES if is_moe(cfg, i) else DENSE_LEAVES)
    return {n: leaves[f"layers.{i}.{n}"].float() for n in names}


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict[str, Any],
          i: int, pos: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    x = x + attention(rmsnorm(x, w["ln1"], eps), w, cfg, pos, precision)
    h = rmsnorm(x, w["ln2"], eps)
    if is_moe(cfg, i):
        return x + experts(h, w, cfg, precision)
    return x + swiglu(h, w["wg"], w["wi"], w["wd"], precision)


@torch.no_grad()
def logits_at(cfg: Dict[str, Any], leaves: Dict[str, torch.Tensor],
              tokens: torch.Tensor, at: Sequence[int],
              precision: str = "f32") -> torch.Tensor:
    """The float32 logits [len(at), vocab] at the positions ``at`` of the
    sequence ``tokens`` [T] (each position's logits predict the next
    token)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = F.embedding(tokens, leaves["embed"]).float()
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, layer_leaves(leaves, cfg, i), cfg, i, pos, precision)
    x = rmsnorm(x[list(at)], leaves["ln_f"].float(), cfg["rms_norm_eps"])
    return _mm(x, leaves["unembed"].float(), precision)
