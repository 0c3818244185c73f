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

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``flash_attention.launches`` counts wrapper calls that launched.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attn_split import DTYPES, aligned, check_kv_map, expand_kv, sm_count
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS"]

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None,
                    kv_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,T,H,D]; k/v: [B,S,Hk,D], the stored KV heads; ``kv_map``:
    int32 [H] on q's device, query head -> KV head (None: Hk == H)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale,
                                     kv_map=kv_map)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, T, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hk, D) or v.shape != (B, S, Hk, D):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    check_kv_map("flash_attention", kv_map, H, Hk, q.device)
    q, k, v = (aligned(x) for x in (q, k, v))
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
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
        None if kv_map is None else kv_map.data_ptr(),
        DTYPES[q.dtype], B, T, S, H, Hk, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), int(q_offset), float(scale),
        n_split, per, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
