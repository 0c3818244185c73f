"""Building blocks of the PyTorch model, in the JAX package's layouts.

Weights are ``[d_in, d_out]`` and used as ``x @ w``; attention tensors are
``[B, T, H, D]``. Initialisation takes an explicit ``torch.Generator`` and
draws in float32 on the generator's device before casting into the
parameter, so one seed gives the same weights on any device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .sharding import copy_to, reduce_from, splits_of

__all__ = ["Dense", "RMSNorm", "SwiGLU", "normal_", "logical_shape",
           "rmsnorm", "rope", "apply_rope", "gqa_attention", "softmax_xent",
           "xent_terms"]


#: float32 values drawn at once by ``normal_``: a larger tensor is drawn
#: in blocks of its leading axis (deepseek-v3's [256, 7168, 2048] experts
#: would need 15 GB of float32 beside their 7.5 GB)
NORMAL_BLOCK = 1 << 30


def logical_shape(param: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole tensor of which ``param`` is a rank's block
    (its ``shard`` and ``z3``, ``models.sharding.Split``s), or its own
    shape."""
    shape = list(param.shape)
    for split in splits_of(param):
        shape[split.dim] *= split.parts
    return tuple(shape)


@torch.no_grad()
def normal_(param: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """Fill ``param`` with N(0, scale^2) drawn in float32 on the generator's
    device, in blocks of its leading axis of at most ``NORMAL_BLOCK``
    values (one draw for any tensor that fits in one). A rank's shard draws
    the whole logical tensor's blocks and keeps its own part of each of its
    splits (``shard`` and ``z3``), so every mesh gets the same weights
    from one seed."""
    splits = splits_of(param)
    shape = logical_shape(param)
    # rows [lo, lo + param.shape[0]) of the logical tensor are this rank's
    lo = sum(s.index * param.shape[0] for s in splits if s.dim == 0)
    step = max(1, NORMAL_BLOCK // max(1, math.prod(shape[1:])))
    for r in range(0, shape[0], step):
        rows = min(step, shape[0] - r)
        x = torch.randn((rows,) + shape[1:], generator=generator,
                        device=generator.device, dtype=torch.float32)
        a, b = max(r, lo), min(r + rows, lo + param.shape[0])
        if a >= b:
            continue
        x.mul_(scale)
        for s in splits:
            if s.dim:
                n = param.shape[s.dim]
                x = x.narrow(s.dim, s.index * n, n)
        param[a - lo:b - lo].copy_(x[a - r:b - r])


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def init(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, 1.0 / math.sqrt(logical_shape(self.w)[0]))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class RMSNorm(nn.Module):
    """Gain kept in float32 whatever the model's dtype, as in JAX."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                         device=device), requires_grad=False)

    def init(self, generator: torch.Generator) -> None:
        self.g.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(self.g, x, eps)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """In float32, cast back to the input's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * g).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope(positions: torch.Tensor, dim: int, theta: float = 1e4,
         yarn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) float32 tables for ``positions`` [..., T] over ``dim``;
    with ``yarn`` (``models.arch.Yarn``) its frequencies and table scale."""
    half = dim // 2
    if yarn is None:
        freqs = 1.0 / (theta ** (torch.arange(
            half, dtype=torch.float32, device=positions.device) / half))
    else:
        freqs = yarn.inv_freq(dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs                # [..., T, half]
    if yarn is not None and yarn.rope_scale != 1.0:
        m = yarn.rope_scale
        return torch.sin(ang) * m, torch.cos(ang) * m
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Half-split rotation. x: [B, T, H, D]; sin/cos: [B, T, D/2] (or
    broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# -------------------------------------------------------------------- SwiGLU
class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.wi = Dense(d, d_ff, dtype=dtype, device=device)
        self.wg = Dense(d, d_ff, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.wi, self.wg, self.wo):
            m.init(generator)

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        """With ``wi``/``wg`` split over the model axis of ``ctx``
        (column-parallel) and ``wo`` with them (row-parallel), the rank's
        partial output is summed over that axis."""
        tp = getattr(self.wo.w, "shard", None)
        if tp is not None:
            x = copy_to(x, ctx, tp.axes)
        y = self.wo(F.silu(self.wg(x)) * self.wi(x))
        return y if tp is None else reduce_from(y, ctx, tp.axes)


# ----------------------------------------------------------------- attention
def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention with materialised scores (the JAX decode
    path's function). q: [B,T,Hq,D], k/v: [B,S,Hkv,D], mask: [T,S] or
    [B,T,S]."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, Hkv, rep, D)
    logits = torch.einsum("bthrd,bshd->bhrts", qg.float() * scale, k.float())
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        logits = torch.where(m[:, None, None], logits,
                             torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrts,bshe->bthre", w, v.float())
    return out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------- loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = -100) -> torch.Tensor:
    """Mean token cross-entropy in float32 over the labels that are not
    ``ignore_index``, as the JAX ``softmax_xent``: ``logsumexp(logits) -
    logits[label]`` a token, summed and divided by the count of valid
    labels (at least 1). The gold logit is a gather here; JAX's one-hot
    select-reduce is the same value, written for a vocab sharded over
    devices."""
    loss, valid = xent_terms(logits, labels, ignore_index)
    return loss.sum() / valid.sum().clamp(min=1)


def xent_terms(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = -100
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's cross-entropy in float32 (0 where ignored) and the mask
    of the labels counted."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, lse - gold, torch.zeros_like(lse)), valid
