"""Plain PyTorch oracles for the kernels (the semantics of record,
mirroring the JAX package's ``kernels/ref.py``).

The attention oracles accumulate in float32, mask with -1e30 before the
softmax and zero the probabilities of masked keys, so a row with no visible
key gives 0. The Mamba2 SSD oracles (``ssd_ref`` sequential, ``ssd_dual``
chunked) compute in float32 and return ``(y, final_state)``, as does the
RG-LRU recurrence ``rglru_ref``. The scans' backward functions
(``ssd_chunked_bwd_plain``, ``rglru_scan_bwd_plain``) are written out as
formulas, not as autograd of the forward: they are the arithmetic the
backward kernels do.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention_ref", "attention_mask", "decode_attention_ref",
           "ssd_ref", "ssd_dual", "rglru_ref", "ssd_chunked_bwd_plain",
           "rglru_scan_bwd_plain"]

_NEG = -1e30


def _softmax_masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1)
    # a row with no visible key: softmax of equal -1e30 is uniform; the
    # kernels (and the JAX oracles' kernels) give 0 there
    return torch.where(mask.any(-1, keepdim=True), w, torch.zeros_like(w))


def attention_mask(T: int, S: int, *, causal: bool, window: int,
                   q_offset: int, device=None) -> torch.Tensor:
    """[T, S] bool: the keys query row i (at position i + q_offset) sees."""
    qp = torch.arange(T, device=device)[:, None] + q_offset
    kp = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention oracle. q: [B,T,H,D]; k/v: [B,S,H,D]; out in q.dtype."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    mask = attention_mask(T, S, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
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


def ssd_chunked_bwd_plain(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                          init_state: Optional[torch.Tensor],
                          dy: torch.Tensor, dsf: Optional[torch.Tensor], *,
                          chunk: int = 64) -> Tuple[Optional[torch.Tensor],
                                                    ...]:
    """The gradient of the SSD scan (``ssd_ref``/``ssd_dual``): given the
    forward's inputs, ``dy`` [Bz,T,H,hd] and ``dsf`` [Bz,H,hd,N] (the final
    state's adjoint; None for zeros), returns (dx, dB, dC, ddt, dA, dD,
    d init_state), float32; the last is None without an initial state.

    By chunks of ``chunk`` steps (the kernel's Q), with the forward's
    quantities: cs the in-chunk cumsum of dt A and cq = cs[Q-1], G = C B^T,
    E[t,s] = exp(cs_t - cs_s) for s <= t, L = E dt_s, M = G o L,
    w_s = exp(cq - cs_s) dt_s, s_in the state entering the chunk and ds the
    adjoint of the state leaving it (dsf for the last chunk, the next
    chunk's ds_in otherwise):

        dx    = M^T dy + w o (B ds^T) + D dy
        dM    = dy x^T (s <= t);  dG = sum_h dM o L;  dL = dM o G
        dC    = dG B + sum_h exp(cs) o (dy s_in)
        dB    = dG^T C + sum_h (x o w) ds
        dw_s  = sum_p x[s,p] (B ds^T)[s,p]
        dcs_t = sum_s dL L[t,s] - sum_r dL L[r,t] + exp(cs_t) <dy_t, C_t s_in^T>
                - dw_t w_t + [t = Q-1] (sum_s dw_s w_s + exp(cq) <ds, s_in>)
        ddt_s = sum_t dL E[t,s] + dw_s exp(cq - cs_s) + A sum_{t>=s} dcs_t
        dA    = sum dt_s sum_{t>=s} dcs_t;   dD = sum x dy
        ds_in = exp(cq) ds + sum_t exp(cs_t) dy_t^T C_t

    The chunk-entry states are recomputed here (the forward saves none).
    Padding past T uses dt = 0, as the forward's.
    """
    Bz, T, H, hd = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    Af = A.float()
    s0 = _ssd_init_state(x, N, init_state)
    ds = (torch.zeros_like(s0) if dsf is None else dsf.float())
    if T == 0:
        z = torch.zeros(H, dtype=f32, device=x.device)
        return (torch.zeros_like(x, dtype=f32), torch.zeros_like(B, dtype=f32),
                torch.zeros_like(C, dtype=f32), torch.zeros_like(dt, dtype=f32),
                z, z.clone(), None if init_state is None else ds)
    Q = chunk
    nc = -(-T // Q)
    pad = nc * Q - T

    def chunks(a, *tail):
        a = torch.nn.functional.pad(a.float(),
                                    (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(Bz, nc, Q, *tail)

    xc, dyc = chunks(x, H, hd), chunks(dy, H, hd)
    Bc, Cc, dtc = chunks(B, N), chunks(C, N), chunks(dt, H)
    cs = torch.cumsum(dtc * Af, dim=2)                       # [Bz,nc,Q,H]
    cq = cs[:, :, -1]                                        # [Bz,nc,H]
    w = torch.exp(cq[:, :, None] - cs) * dtc
    ecs = torch.exp(cs)

    # chunk-entry states forward, their adjoints backward
    s, s_in = s0, []
    for c in range(nc):
        s_in.append(s)
        s = torch.exp(cq[:, c])[..., None, None] * s + torch.einsum(
            "bqhp,bqn->bhpn", xc[:, c] * w[:, c, ..., None], Bc[:, c])
    dso = [None] * nc
    for c in reversed(range(nc)):
        dso[c] = ds
        ds = torch.exp(cq[:, c])[..., None, None] * ds + torch.einsum(
            "bqhp,bqn->bhpn", dyc[:, c] * ecs[:, c, ..., None], Cc[:, c])
    s_in, dso = torch.stack(s_in, 1), torch.stack(dso, 1)    # [Bz,nc,H,P,N]

    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)              # [Bz,nc,Q,Q]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    expo = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # [Bz,nc,t,s,H]
    E = torch.exp(torch.where(causal[None, None, :, :, None], expo,
                              torch.full_like(expo, -math.inf)))
    L = E * dtc[:, :, None, :, :]
    M = G[..., None] * L
    dM = torch.einsum("bcthp,bcshp->bctsh", dyc, xc) \
        * causal[None, None, :, :, None]
    dG = (dM * L).sum(-1)                                    # [Bz,nc,t,s]
    dL = dM * G[..., None]

    BdsT = torch.einsum("bcsn,bchpn->bcshp", Bc, dso)
    dx = (torch.einsum("bctsh,bcthp->bcshp", M, dyc) + w[..., None] * BdsT
          + D.float()[:, None] * dyc)
    dC = (torch.einsum("bcts,bcsn->bctn", dG, Bc)
          + torch.einsum("bcthp,bchpn->bctn", ecs[..., None] * dyc, s_in))
    dB = (torch.einsum("bcts,bctn->bcsn", dG, Cc)
          + torch.einsum("bcshp,bchpn->bcsn", w[..., None] * xc, dso))

    dw = (xc * BdsT).sum(-1)                                 # [Bz,nc,Q,H]
    dexp = (dyc * torch.einsum("bctn,bchpn->bcthp", Cc, s_in)).sum(-1)
    LL = dL * L
    dcs = LL.sum(3) - LL.sum(2) + ecs * dexp - dw * w
    dcs[:, :, -1] += (dw * w).sum(2) + torch.exp(cq) * (dso * s_in).sum(
        (-2, -1))
    S = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])  # t >= s
    ddt = (dL * E).sum(2) + dw * torch.exp(cq[:, :, None] - cs) + Af * S
    dA = (dtc * S).sum((0, 1, 2))
    dD = (xc * dyc).sum((0, 1, 2, 4))

    def unchunk(a):
        return a.reshape(Bz, nc * Q, *a.shape[3:])[:, :T]
    return (unchunk(dx), unchunk(dB), unchunk(dC), unchunk(ddt), dA, dD,
            None if init_state is None else ds)


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                         init_state: Optional[torch.Tensor],
                         dh: torch.Tensor, dhf: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """The gradient of ``rglru_ref``: given a, the forward's h, its initial
    state, ``dh`` [B,T,W] and ``dhf`` [B,W] (the final state's adjoint; None
    for zeros), returns (da, dx, d init_state), float32, the last None
    without an initial state. The reverse loop over T:

        g_{T-1} = dh_{T-1} + dhf;  g_t = dh_t + a_{t+1} g_{t+1}
        dx_t = g_t;  da_t = g_t h_{t-1} (h_{-1} = init_state or 0);
        d init_state = a_0 g_0
    """
    Bsz, T, W = a.shape
    af, hf, dhf32 = a.float(), h.float(), dh.float()
    g = (torch.zeros((Bsz, W), dtype=torch.float32, device=a.device)
         if dhf is None else dhf.float())    # the adjoint carried into t
    h0 = (torch.zeros((Bsz, W), dtype=torch.float32, device=a.device)
          if init_state is None else init_state.float())
    dx = torch.empty((Bsz, T, W), dtype=torch.float32, device=a.device)
    da = torch.empty_like(dx)
    for t in reversed(range(T)):
        g = dhf32[:, t] + g
        dx[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else h0)
        g = af[:, t] * g
    return da, dx, None if init_state is None else g
