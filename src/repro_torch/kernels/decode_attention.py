"""Decode attention: the Hopper kernel ``csrc/decode_attention.cu``, its
plain PyTorch version, the wrapper and the kernel's cost count.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention`` (Pallas). On the
H100 this kernel is bound by the bytes of the KV cache it reads (about one
flop per byte); this first design reads only the keys below each sequence's
length, with one block per (sequence, head). Splitting the KV axis over
blocks (flash-decoding) is left to the kernel's redesign.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .flash_attention import HEAD_DIMS, _DTYPES
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_cost"]

#: the plain PyTorch version of the kernel: the oracle of ``ref.py``
decode_attention_plain = decode_attention_ref


def decode_attention_cost(n_seqs: int, n_heads: int, head_dim: int,
                          ctx: int, *, block_k: int = 128,
                          dtype_bytes: int = 2) -> tuple:
    """Per-layer (flops, hbm_bytes) of one batched decode-attention step
    with this kernel's tiling, for ``StageProfile.decode_step_roofline``.

    The kernel scores exactly the ``ctx`` keys below the length (no head-dim
    padding, no padded KV block), so per sequence and head it runs
    ``4 * head_dim * ctx`` flops and reads K and V once plus q and the
    output. ``block_k`` is the keys scored per step; it changes neither
    count and stays for the signature the shared ``StageProfile`` calls.
    """
    S = max(int(ctx), 1)
    flops = n_seqs * 4.0 * n_heads * head_dim * S
    hbm = n_seqs * (2.0 * S * n_heads * head_dim * dtype_bytes      # K+V
                    + 2.0 * n_heads * head_dim * dtype_bytes)       # q+out
    return flops, hbm


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,D]; k/v: [B,S,H,D]; lengths: [B] valid cache slots."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, H, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != (B, S, H, D) \
            or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention: q, k, v on different devices")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], B, S, H, D,
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
