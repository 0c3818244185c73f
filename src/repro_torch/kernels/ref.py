"""Plain PyTorch oracles for the attention kernels (the semantics of
record, mirroring the JAX package's ``kernels/ref.py``).

Both accumulate in float32, mask with -1e30 before the softmax and zero the
probabilities of masked keys, so a row with no visible key gives 0. The
``ssd``/``rglru`` oracles arrive with the slices that need them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_ref", "decode_attention_ref"]

_NEG = -1e30


def _softmax_masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1)
    # a row with no visible key: softmax of equal -1e30 is uniform; the
    # kernels (and the JAX oracles' kernels) give 0 there
    return torch.where(mask.any(-1, keepdim=True), w, torch.zeros_like(w))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention oracle. q: [B,T,H,D]; k/v: [B,S,H,D]; out in q.dtype."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    qp = torch.arange(T, device=q.device)[:, None] + q_offset
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    w = _softmax_masked(logits, mask[None, None])
    out = torch.einsum("bhts,bshd->bthd", w, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over a padded KV cache.

    q: [B,H,D]; k/v: [B,S,H,D]; lengths: [B] — number of valid cache slots.
    """
    B, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bhd,bshd->bhs", q.float() * scale, k.float())
    mask = (torch.arange(S, device=q.device)[None]
            < lengths.to(q.device)[:, None])                   # [B, S]
    w = _softmax_masked(logits, mask[:, None])
    return torch.einsum("bhs,bshd->bhd", w, v.float()).to(q.dtype)
