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

__all__ = ["Dense", "RMSNorm", "SwiGLU", "normal_", "rmsnorm", "rope",
           "apply_rope", "gqa_attention"]


#: float32 values drawn at once by ``normal_``: a larger tensor is drawn
#: in blocks of its leading axis (deepseek-v3's [256, 7168, 2048] experts
#: would need 15 GB of float32 beside their 7.5 GB)
NORMAL_BLOCK = 1 << 30


@torch.no_grad()
def normal_(param: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """Fill ``param`` with N(0, scale^2) drawn in float32 on the generator's
    device, in blocks of its leading axis of at most ``NORMAL_BLOCK``
    values (one draw for any tensor that fits in one)."""
    step = max(1, NORMAL_BLOCK // max(1, param[0].numel()))
    for r in range(0, param.shape[0], step):
        x = torch.randn(param[r:r + step].shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        param[r:r + step].copy_(x.mul_(scale))


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def init(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, 1.0 / math.sqrt(self.w.shape[0]))
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
def rope(positions: torch.Tensor, dim: int, theta: float = 1e4
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) float32 tables for ``positions`` [..., T] over ``dim``."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs                # [..., T, half]
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.silu(self.wg(x)) * self.wi(x))


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
