"""Prefill attention: the Hopper kernel ``csrc/flash_attention.cu``, its
plain PyTorch version and the wrapper that picks between them.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(Pallas). On the H100 the prefill shapes are bound by arithmetic (see the
header of the CUDA source); this first kernel computes in float32 on the CUDA
cores, stages K/V tiles in shared memory and skips the tiles no row of a
query tile can see. The head dim is not padded (the TPU padded it to its
128-lane width).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the plain PyTorch version of the kernel: the oracle of ``ref.py``
flash_attention_plain = flash_attention_ref


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, L,
                       I, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,T,H,D]; k/v: [B,S,H,D] (heads already mapped to q heads)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, T, H, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, D) or v.shape != (B, S, H, D):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, T, S, H, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), int(q_offset), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
