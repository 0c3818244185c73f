"""Plain PyTorch oracles for the kernels (the semantics of record,
mirroring the JAX package's ``kernels/ref.py``).

The attention oracles accumulate in float32, mask with -1e30 before the
softmax and zero the probabilities of masked keys, so a row with no visible
key gives 0. The Mamba2 SSD oracles (``ssd_ref`` sequential, ``ssd_dual``
chunked) compute in float32 and return ``(y, final_state)``, as does the
RG-LRU recurrence ``rglru_ref``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention_ref", "decode_attention_ref", "ssd_ref",
           "ssd_dual", "rglru_ref"]

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


def _ssd_init_state(x: torch.Tensor, N: int,
                    init_state: Optional[torch.Tensor]) -> torch.Tensor:
    Bz, _, H, hd = x.shape
    if init_state is None:
        return torch.zeros((Bz, H, hd, N), dtype=torch.float32,
                           device=x.device)
    return init_state.float()


def ssd_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD recurrence (state-space duality), sequential over time.

        s_t = exp(dt_t * A) * s_{t-1} + dt_t * x_t B_t^T
        y_t = C_t s_t + D * x_t

    x: [Bsz,T,H,hd]; B/C: [Bsz,T,N]; dt: [Bsz,T,H]; A/D: [H].
    Returns (y [Bsz,T,H,hd], final_state [Bsz,H,hd,N]), both float32.
    """
    N = B.shape[-1]
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    dA = torch.exp(dtf * A.float()[None, None, :])            # [Bsz,T,H]
    s = _ssd_init_state(x, N, init_state)
    ys = []
    for t in range(x.shape[1]):
        s = s * dA[:, t, :, None, None] + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :]
        ys.append(torch.einsum("bhdn,bn->bhd", s, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else torch.zeros_like(xf)
    return y + xf * D.float()[None, None, :, None], s


def ssd_dual(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             init_state: Optional[torch.Tensor] = None, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD via the chunked *dual* (matmul) form: the function the
    TPU kernel ``ssd_chunked`` computes. Per chunk of ``Q`` steps, with the
    chunk's cumulative log-decay ``cs_t = sum_{r<=t} dt_r A``:

        y_intra = ((C B^T) o L) x      L[t,s] = exp(cs_t - cs_s) dt_s, s <= t
        y_inter = exp(cs) (C state^T)
        state'  = exp(cs_Q) state + (x (exp(cs_Q - cs) dt))^T B

    The chunk-boundary states are carried by a loop over chunks (the JAX
    oracle's associative scan; the same values up to rounding).
    """
    Bz, T, H, hd = x.shape
    N = B.shape[-1]
    Q = max(1, min(chunk, T))
    pad = (-T) % Q

    def padt(a):
        # dt=0 padding keeps the state: decay exp(0)=1, input weight 0
        return torch.nn.functional.pad(
            a.float(), (0, 0) * (a.dim() - 2) + (0, pad))

    xf, Bf, Cf, dtf = padt(x), padt(B), padt(C), padt(dt)
    nc = (T + pad) // Q
    xc = xf.reshape(Bz, nc, Q, H, hd)
    Bc = Bf.reshape(Bz, nc, Q, N)
    Cc = Cf.reshape(Bz, nc, Q, N)
    dtc = dtf.reshape(Bz, nc, Q, H)
    cs = torch.cumsum(dtc * A.float()[None, None, None, :], dim=2)
    cq = cs[:, :, -1]                                        # [Bz,nc,H]

    w = torch.exp(cq[:, :, None] - cs) * dtc                 # [Bz,nc,Q,H]
    inc = torch.einsum("bcqhd,bcqn->bchdn", xc * w[..., None], Bc)
    decay = torch.exp(cq)                                    # [Bz,nc,H]
    s = _ssd_init_state(x, N, init_state)
    s_in = []                                                # entering chunk c
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c, :, None, None] * s + inc[:, c]
    s_in = torch.stack(s_in, 1)                              # [Bz,nc,H,hd,N]

    y_inter = torch.exp(cs)[..., None] * torch.einsum(
        "bcqn,bchdn->bcqhd", Cc, s_in)
    G = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)              # [Bz,nc,Q,Q]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    expo = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # [Bz,nc,t,s,H]
    expo = torch.where(causal[None, None, :, :, None], expo,
                       torch.full_like(expo, _NEG))
    L = torch.exp(expo) * dtc[:, :, None, :, :]              # [Bz,nc,t,s,H]
    y_intra = torch.einsum("bcqsh,bcshd->bcqhd", G[..., None] * L, xc)
    y = (y_inter + y_intra).reshape(Bz, nc * Q, H, hd)[:, :T]
    return y + xf[:, :T] * D.float()[None, None, :, None], s


def rglru_ref(a: torch.Tensor, x: torch.Tensor,
              init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear recurrence  h_t = a_t * h_{t-1} + x_t  (RG-LRU core),
    sequential over time.

    a/x: [B, T, W]. Returns (h [B,T,W], final_state [B,W]), both float32.
    """
    B, T, W = a.shape
    af, xf = a.float(), x.float()
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if init_state is None else init_state.float())
    hs = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = af[:, t] * h + xf[:, t]
        hs[:, t] = h
    return hs, h
