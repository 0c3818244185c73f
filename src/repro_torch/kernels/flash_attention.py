"""Prefill attention: the Hopper kernel ``csrc/flash_attention.cu``, its
plain PyTorch version and the wrapper that picks between them.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(Pallas). On the H100 the prefill shapes are bound by arithmetic (see the
header of the CUDA source). In bfloat16 the kernel is FlashAttention-2 on
``mma.sync`` tensor-core tiles: 64 query rows a block, 64-key K/V tiles in
a 2-stage ``cp.async`` ring, the softmax in registers. Query head ``h``
reads stored KV head ``kv_map[h]``, so GQA and MQA need no expanded copy.
When ``B*H*ceil(T/64)`` blocks would leave SMs idle (a short suffix over a
long cache), each query tile's visible KV tiles are split into chunks whose
float32 partials one combine kernel merges; the split is chosen here from
the Python ints T, S, q_offset and window, never from device data. float32
keeps the CUDA-core kernel: tensor cores take float32 only as TF32, which
cannot hold the 2e-5 the float32 path is held to. The head dim is not
padded (the TPU padded it to its 128-lane width).

The backward (``csrc/flash_attention_bwd.cu``) takes the place of the JAX
package's ``repro/kernels/flash_xla.py::_bwd``, the custom VJP that JAX
differentiates off the TPU: it recomputes the probabilities from the
forward's row log-sum-exp (``lse``, [B, H, T] float32 in base e, which the
forward kernel writes when a gradient is needed) and sums dK/dV over the
query heads of each KV head. ``FlashAttentionFn`` binds the two; the
kernels are reached through ctypes, so autograd sees them only through it.
``flash_attention`` goes through it whenever a gradient is needed.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``flash_attention.launches`` counts wrapper calls that launched the
forward, ``flash_attention_bwd.launches`` those that launched the backward.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .attn_split import DTYPES, aligned, check_kv_map, expand_kv, sm_count
from .ref import attention_mask, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_lse_plain",
           "FlashAttentionFn", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 96, 128, 256)
BLOCK_M = 64            # query rows a block of the bfloat16 kernel


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale: Optional[float] = None,
                          kv_map: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain PyTorch version: K/V expanded through ``kv_map``, then the
    oracle of ``ref.py``."""
    return flash_attention_ref(q, expand_kv(k, kv_map), expand_kv(v, kv_map),
                               causal=causal, window=window,
                               q_offset=q_offset, scale=scale)


def _scores(q, k, *, causal, window, q_offset, scale, kv_map):
    """float32 scores [B, H, T, S] of the scaled queries, -inf where masked,
    and the scale used."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale,
                     expand_kv(k, kv_map).float())
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, q_offset=q_offset, device=q.device)
    return s.masked_fill(~mask, -math.inf), scale


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              q_offset: int = 0, scale: Optional[float] = None,
                              kv_map: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The forward's row log-sum-exp, [B, H, T] float32 in base e (``-inf``
    for a row with no visible key): the ``lse`` of JAX's ``flash_xla._fwd``
    and of the kernel's ``lse_out``."""
    s, _ = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                   scale=scale, kv_map=kv_map)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              q_offset: int = 0, scale: Optional[float] = None,
                              kv_map: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain PyTorch version of the backward kernel: JAX's
    ``flash_xla._bwd`` unblocked, in float32. ``delta = rowsum(dout * out)``,
    ``p = exp(scale q.k - lse)`` (0 where masked), ``dv = p^T dout``, ``ds =
    p (dout v^T - delta) scale``, ``dq = ds k``, ``dk = ds^T q``, with dk/dv
    of the query heads summed into the KV head each reads. Returns (dq, dk,
    dv) in the dtypes of q, k, v."""
    s, scale = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                       scale=scale, kv_map=kv_map)
    live = torch.isfinite(s) & torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)   # [B,H,T,S]
    do32 = dout.float()
    delta = torch.einsum("bthd,bthd->bht", out.float(), do32)
    dp = torch.einsum("bthd,bshd->bhts", do32, expand_kv(v, kv_map).float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, expand_kv(k, kv_map).float())
    dk_h = torch.einsum("bhts,bthd->bshd", ds, q.float())       # per q head
    dv_h = torch.einsum("bhts,bthd->bshd", p, do32)
    if kv_map is None:
        dk, dv = dk_h, dv_h
    else:
        idx = kv_map.to(device=q.device, dtype=torch.long).clamp(
            0, k.shape[2] - 1)
        dk = torch.zeros(k.shape, dtype=torch.float32,
                         device=q.device).index_add_(2, idx, dk_h)
        dv = torch.zeros(v.shape, dtype=torch.float32,
                         device=q.device).index_add_(2, idx, dv_h)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, L,
                       I, I, I, ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
        t = lib.flash_attention_tiling
        t.argtypes = [I, ctypes.POINTER(I), ctypes.POINTER(I)]
        t.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tiling(D: int) -> Tuple[int, int]:
    """(keys a KV tile, resident blocks an SM) of the bfloat16 kernel."""
    bn, occ = ctypes.c_int(), ctypes.c_int()
    err = _lib().flash_attention_tiling(D, ctypes.byref(bn), ctypes.byref(occ))
    if err:
        raise RuntimeError(f"flash_attention tiling query failed: "
                           f"cudaError {err}")
    return bn.value, max(1, occ.value)


def visible_tiles(q0: int, T: int, S: int, bn: int, *, causal: bool,
                  window: int, q_offset: int) -> int:
    """KV tiles of ``bn`` keys that query tile ``q0`` sees: the kernel's
    ``visible_tiles``, which splits the same range."""
    q_last = min(q0 + BLOCK_M, T) - 1 + q_offset
    kv_end = min(S, q_last + 1) if causal else S
    kv_begin = max(0, q0 + q_offset - window + 1) if window > 0 else 0
    if kv_end <= kv_begin:
        return 0
    return -(-kv_end // bn) - kv_begin // bn


def split_plan(B: int, H: int, T: int, S: int, *, causal: bool, window: int,
               q_offset: int, bn: int, sms: int, blocks_per_sm: int
               ) -> Tuple[int, int]:
    """(n_split, tiles a chunk). No split while the B*H*ceil(T/64) blocks
    reach the SM count; else the widest query tile's visible tiles are cut
    into as many chunks as one wave of resident blocks holds."""
    n_qt = -(-T // BLOCK_M)
    blocks = B * H * n_qt
    if blocks >= sms:
        return 1, 1 << 20
    tiles = max(visible_tiles(i * BLOCK_M, T, S, bn, causal=causal,
                              window=window, q_offset=q_offset)
                for i in range(n_qt))
    n_split = min(tiles, max(1, sms * blocks_per_sm // blocks))
    if n_split <= 1:
        return 1, 1 << 20
    per = -(-tiles // n_split)
    return -(-tiles // per), per


def _check(name: str, q, k, v, kv_map) -> None:
    """Raise unless the attention kernels take these CUDA tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    B, T, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hk, D) or v.shape != (B, S, Hk, D):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "the kernel takes float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    check_kv_map(name, kv_map, H, Hk, q.device)


def _forward(q, k, v, *, causal, window, q_offset, scale, kv_map,
             with_lse: bool):
    """Launch the forward kernel; returns (out, lse or None)."""
    _check("flash_attention", q, k, v, kv_map)
    B, T, H, D = q.shape
    S = k.shape[1]
    q, k, v = (aligned(x) for x in (q, k, v))
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse_out = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
               if with_lse else None)
    if out.numel() == 0:
        return out, lse_out
    n_split, per = 1, 1 << 20
    if q.dtype == torch.bfloat16:
        bn, occ = _tiling(D)
        n_split, per = split_plan(B, H, T, S, causal=causal, window=window,
                                  q_offset=q_offset, bn=bn,
                                  sms=sm_count(q.device), blocks_per_sm=occ)
    opart = lse = None
    if n_split > 1:
        opart = torch.empty((n_split, B * T * H, D), dtype=torch.float32,
                            device=q.device)
        lse = torch.empty((n_split, B * T * H), dtype=torch.float32,
                          device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if opart is None else opart.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if lse_out is None else lse_out.data_ptr(),
        None if kv_map is None else kv_map.data_ptr(),
        DTYPES[q.dtype], B, T, S, H, k.shape[2], D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), int(q_offset), float(scale),
        n_split, per, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out, lse_out


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 13 + [I] * 10 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _groups(kv_map_host: Tuple[int, ...], Hk: int, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of the query-head -> KV-head map, built on the host from
    its Python ints (clamped to ``[0, Hk)`` as the kernels clamp): int32
    ``group_off`` [Hk + 1] and ``group_heads`` [H] on ``device``, the query
    heads of KV head j at ``group_heads[group_off[j]:group_off[j + 1]]``.
    Made once per map and device."""
    kv = [min(max(int(m), 0), Hk - 1) for m in kv_map_host]
    heads = sorted(range(len(kv)), key=lambda h: (kv[h], h))
    off = [0] * (Hk + 1)
    for m in kv:
        off[m + 1] += 1
    for j in range(Hk):
        off[j + 1] += off[j]
    return (torch.tensor(off, dtype=torch.int32, device=device),
            torch.tensor(heads, dtype=torch.int32, device=device))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        scale: Optional[float] = None,
                        kv_map: Optional[torch.Tensor] = None,
                        kv_map_host: Optional[Sequence[int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its output, its
    row log-sum-exp ``lse`` [B, H, T] and the output's gradient ``dout``.
    ``kv_map_host``: the same map as ``kv_map``, as Python ints, from which
    the kernel's inverse map is built (the device map is never read back);
    required with a ``kv_map`` on CUDA tensors."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              kv_map=kv_map)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    _check("flash_attention_bwd", q, k, v, kv_map)
    B, T, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {lse.dtype} "
                         f"{tuple(lse.shape)} for q {tuple(q.shape)}")
    if kv_map is not None and (kv_map_host is None
                               or len(kv_map_host) != H):
        raise ValueError("flash_attention_bwd: a kv_map needs kv_map_host, "
                         f"its {H} Python ints")
    groups = _groups(tuple(kv_map_host) if kv_map is not None
                     else tuple(range(H)), Hk, q.device)
    q, k, v, out, dout, lse = (x.contiguous() for x in (q, k, v, out,
                                                         dout.to(q.dtype),
                                                         lse))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        None if kv_map is None else kv_map.data_ptr(),
        groups[0].data_ptr(), groups[1].data_ptr(),
        DTYPES[q.dtype], B, T, S, H, Hk, D, int(causal), int(window),
        int(q_offset), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the backward of ``flash_attention_bwd``: the forward
    saves (q, k, v, out, lse). On CUDA tensors both directions launch the
    kernels; on CPU tensors they run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, kv_map,
                kv_map_host):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  scale=scale, kv_map=kv_map)
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, **kw)
            lse = flash_attention_lse_plain(q, k, **kw)
        else:
            if kv_map is not None and (kv_map_host is None
                                       or len(kv_map_host) != q.shape[2]):
                raise ValueError("flash_attention: a gradient through a "
                                 "kv_map needs kv_map_host, its Python ints")
            out, lse = _forward(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(kw, kv_map_host=kv_map_host)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None,
                    kv_map: Optional[torch.Tensor] = None,
                    kv_map_host: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """q: [B,T,H,D]; k/v: [B,S,Hk,D], the stored KV heads; ``kv_map``:
    int32 [H] on q's device, query head -> KV head (None: Hk == H);
    ``kv_map_host``: the same map as Python ints, which the backward needs
    on CUDA tensors. When a gradient is needed this goes through
    ``FlashAttentionFn``."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              kv_map=kv_map)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      scale, kv_map, kv_map_host)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    return _forward(q, k, v, with_lse=False, **kw)[0]


flash_attention.launches = 0
