"""Decode attention: the Hopper kernel ``csrc/decode_attention.cu``, its
plain PyTorch version, the wrapper and the kernel's cost count.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention`` (Pallas). On the
H100 this kernel is bound by the bytes of the KV cache it reads while few
query heads share a KV head; with 16 on one (MQA) each bf16 K/V element
feeds 16 products, 32 flops a byte, which is past the ~20 flop/byte ridge
of the float32 CUDA cores it computes on, so there the arithmetic binds
(see the CUDA source). It is flash-decoding over the stored KV heads: a block
takes one sequence, one stored KV head and one chunk of keys, and serves
every query head that ``kv_map`` sends to that KV head, so each K/V row is
read once; the chunks' float32 partials are merged by one combine kernel.
The number of chunks comes from S and the grid's other axes, chosen here
from Python ints: neither ``lengths`` nor ``kv_map`` is read on the host.

K/V may be int8 codes (the model's int8 KV cache) whose value is ``code *
kv_scale``: the kernel reads the codes themselves, one byte an element,
and converts them in registers; no dequantised copy of the cache is made
on the card. The plain version dequantises first (``kv_dequant``, which
the model's ``blocks._kv_load`` calls too), then calls the oracle.

``partial=True`` is the mode of a rank of a sequence-sharded cache
(``models.blocks``): K/V are the rank's slots and ``lengths`` the keys it
holds of each sequence, and the call returns the rank's partial, the
float32 output normalised over those keys, with its base-2 log-sum-exp
(``-inf``, and an output of 0, for a row that sees none of them), for
``attn_split.attn_merge`` to merge with the other ranks'.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``decode_attention.launches`` counts wrapper calls that launched.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from . import _build, meta
from .attn_split import DTYPES, aligned, check_kv_map, expand_kv, sm_count
from .flash_attention import HEAD_DIMS
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_cost", "decode_attention_traffic", "kv_dequant",
           "partial_softmax"]

TILE = 64               # keys a tile of the kernel; a chunk is a multiple
#: K/V dtypes the kernel takes (q's, or int8), by their code in the C
#: interface
KV_DTYPES = {**DTYPES, torch.int8: 2}


def _check_kv_scale(k: torch.Tensor, kv_scale: Optional[float]) -> None:
    if (k.dtype == torch.int8) != (kv_scale is not None):
        raise ValueError(f"decode_attention: K/V of {k.dtype} with kv_scale "
                         f"{kv_scale}: int8 codes need the value of one "
                         "code, and only they take one")


def kv_dequant(x: torch.Tensor, kv_scale: float,
               dtype: torch.dtype) -> torch.Tensor:
    """The values of int8 K/V codes in ``dtype``: ``code * kv_scale`` in
    float32, cast (exact in bfloat16 and float32 for the model's scale of
    1/32)."""
    return (x.float() * kv_scale).to(dtype)


Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None,
                           kv_map: Optional[torch.Tensor] = None,
                           kv_scale: Optional[float] = None,
                           partial: bool = False) -> Out:
    """The plain PyTorch version: int8 K/V dequantised to q's dtype
    (``kv_dequant``), K/V expanded through ``kv_map``, then the oracle of
    ``ref.py`` (``_partial_plain`` with ``partial``)."""
    _check_kv_scale(k, kv_scale)
    if kv_scale is not None:
        k, v = (kv_dequant(x, kv_scale, q.dtype) for x in (k, v))
    k, v = expand_kv(k, kv_map), expand_kv(v, kv_map)
    if partial:
        return _partial_plain(q, k, v, lengths, scale)
    return decode_attention_ref(q, k, v, lengths, scale=scale)


def partial_softmax(s: torch.Tensor, mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A partial's softmax over the keys one holds: scores ``s`` [..., S]
    (float32, natural base) where ``mask``, normalised over those keys, and
    their base-2 log-sum-exp; weights of 0 and ``-inf`` on a row that sees
    none. The weights times the values are the partial's output."""
    s = torch.where(mask, s, -math.inf)
    m = s.amax(-1)
    m = torch.where(torch.isinf(m), 0.0, m)                  # empty rows
    p = torch.exp(s - m[..., None])
    den = p.sum(-1)
    w = p / torch.where(den > 0, den, 1.0)[..., None]
    lse = torch.where(den > 0, (m + torch.log(den)) / math.log(2.0),
                      -math.inf)
    return w, lse


def _partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, scale: Optional[float]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial mode over K/V of the H query heads: the float32 output
    normalised over the first ``lengths[b]`` keys and the base-2
    log-sum-exp of the scaled scores; 0 and ``-inf`` on an empty row."""
    S, D = k.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, k.float())
    mask = (torch.arange(S, device=q.device)[None]
            < lengths.to(q.device)[:, None])[:, None]          # [B, 1, S]
    w, lse = partial_softmax(s, mask)
    return torch.einsum("bhs,bshd->bhd", w, v.float()), lse


def decode_attention_cost(n_seqs: int, n_heads: int, head_dim: int,
                          ctx: int, *, block_k: int = 128,
                          dtype_bytes: int = 2) -> tuple:
    """Per-layer (flops, hbm_bytes) of one batched decode-attention step,
    for ``StageProfile.decode_step_roofline``.

    ``n_heads`` is the stored KV heads (what ``StageProfile`` passes),
    which is what the kernel reads: each K/V row once, for all the query
    heads that share it, exactly the ``ctx`` keys below the length (no
    head-dim padding, no padded KV block), plus q and the output a KV head.
    The flops, ``4 * head_dim * ctx`` a KV head, count one query head of
    each group: the step is bound by the bytes. ``block_k`` changes
    neither count and stays for the signature ``StageProfile`` calls.
    """
    S = max(int(ctx), 1)
    flops = n_seqs * 4.0 * n_heads * head_dim * S
    hbm = n_seqs * (2.0 * S * n_heads * head_dim * dtype_bytes      # K+V
                    + 2.0 * n_heads * head_dim * dtype_bytes)       # q+out
    return flops, hbm


def decode_attention_traffic(B: int, H: int, Hk: int, D: int, S: int,
                             lengths: Sequence[int], *, cap: int, sms: int,
                             dtype_bytes: int = 2,
                             q_bytes: Optional[int] = None,
                             kv_map: Optional[Sequence[int]] = None) -> dict:
    """The HBM bytes one (non-partial) call of the kernel moves, counted in
    Python from its launch plan (``split_plan``) and its loop bounds
    (``csrc/decode_attention.cu``: the block of chunk ``c`` reads K/V rows
    ``[c * chunk, min((c + 1) * chunk, len))``; rows past the end are
    zero-filled in shared memory, not read; a block that serves no query
    head has already issued its first tile's copy). ``cap`` is
    ``_cap(D)`` and ``sms`` the card's SM count, given here so that no
    library is built; ``dtype_bytes`` is a K/V element's, ``q_bytes`` q's
    and the output's (default: the same); ``kv_map`` a list of H ints
    (None: the identity). Returns the bytes of the K/V rows read (``kv``),
    of q as every chunk's block loads it (``q``), of the output (``out``),
    of the float32 partials and their log-sum-exps written by the chunks
    and read back by the combine kernel when ``n_split`` > 1
    (``partials``), and ``n_split``. The lengths and the map, 4 bytes an
    entry a block, are left out."""
    qb = dtype_bytes if q_bytes is None else q_bytes
    if kv_map is None and H != Hk:
        raise ValueError(f"decode_attention_traffic: {H} query heads over "
                         f"{Hk} KV heads need a map")
    heads = [min(max(int(m), 0), Hk - 1) for m in kv_map] \
        if kv_map is not None else list(range(H))
    group = [heads.count(k) for k in range(Hk)]
    cap = min(cap, H)
    chunk, n_split, n_hb = split_plan(B, H, Hk, S, cap=cap, sms=sms)
    kv_rows = q_rows = 0
    for n in lengths:
        n = min(max(int(n), 0), S)
        rows = [max(min(c * chunk + chunk, n) - c * chunk, 0)
                for c in range(n_split)]
        for k in range(Hk):
            for hb in range(n_hb):
                G = min(max(group[k] - hb * cap, 0), cap)
                kv_rows += sum(rows) if G else sum(min(r, TILE)
                                                   for r in rows)
                q_rows += G * n_split
    partials = 2 * n_split * B * H * (D + 1) * 4 if n_split > 1 else 0
    return {"kv": 2 * kv_rows * D * dtype_bytes, "q": q_rows * D * qb,
            "out": B * H * D * qb, "partials": partials, "n_split": n_split}


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        F = ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, F, F, I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.decode_attention_cap.argtypes = [I]
        lib.decode_attention_cap.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _cap(D: int) -> int:
    """The most query heads one block of the kernel holds at head dim D."""
    return _lib().decode_attention_cap(D)


def split_plan(B: int, H: int, Hk: int, S: int, *, cap: int, sms: int,
               per_sm: int = 4) -> Tuple[int, int, int]:
    """(chunk, n_split, n_hb): query heads in groups of ``cap`` (``n_hb``
    blocks a KV head only when one group would hold more), and S cut into
    ``n_split`` chunks of ``chunk`` keys (a multiple of the tile) so that
    the grid covers the SMs about ``per_sm`` times. On the H100 (two runs
    of ``tools/attention_probe.py``) 1, 2 and 4 were within their
    run-to-run spread at 16 KV heads and at recurrentgemma's MQA, and 4
    was the fastest at smollm's 16 -> 5 GQA in both."""
    cap = min(cap, H)
    n_hb = -(-H // cap)
    blocks = B * Hk * n_hb
    tiles = max(1, -(-S // TILE))
    n_split = min(tiles, max(1, -(-per_sm * sms // blocks)))
    chunk = -(-tiles // n_split) * TILE
    return chunk, -(-S // chunk) if S else 1, n_hb


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     kv_map: Optional[torch.Tensor] = None,
                     kv_scale: Optional[float] = None,
                     partial: bool = False) -> Out:
    """q: [B,H,D]; k/v: [B,S,Hk,D], the stored KV heads, in q's dtype or
    int8 codes worth ``code * kv_scale`` (``kv_scale`` is given for int8
    and only then); lengths: [B] valid cache slots; ``kv_map``: int32 [H]
    on q's device, query head -> KV head (None: Hk == H). Returns [B,H,D]
    in q's dtype, or with ``partial`` (o [B,H,D], lse [B,H]) in float32.
    On meta tensors, outputs of the kernel's shapes (``kernels.meta``), its
    work counted over every one of the S slots."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale,
                                      kv_map=kv_map, kv_scale=kv_scale,
                                      partial=partial)
    if q.device.type == "meta":
        B, H, D = q.shape
        meta.count("decode_attention", 4.0 * H * D * B * k.shape[1])
        if partial:
            return meta.empty(B, H, D), meta.empty(B, H)
        return meta.empty(B, H, D, dtype=q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hk, D) or v.shape != (B, S, Hk, D) \
            or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in DTYPES or k.dtype not in (q.dtype, torch.int8) \
            or v.dtype != k.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes q in float32 or "
                         "bfloat16 and K/V in q's dtype or int8")
    _check_kv_scale(k, kv_scale)
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention: q, k, v on different devices")
    check_kv_map("decode_attention", kv_map, H, Hk, q.device)
    q, k, v = aligned(q), aligned(k), aligned(v)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=torch.float32 if partial else q.dtype,
                      device=q.device)
    lse_out = (torch.empty((B, H), dtype=torch.float32, device=q.device)
               if partial else None)
    if out.numel() == 0:
        return (out, lse_out) if partial else out
    chunk, n_split, n_hb = split_plan(B, H, Hk, S, cap=_cap(D),
                                      sms=sm_count(q.device))
    opart = lse = None
    if n_split > 1:
        opart = torch.empty((n_split, B * H, D), dtype=torch.float32,
                            device=q.device)
        lse = torch.empty((n_split, B * H), dtype=torch.float32,
                          device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        None if kv_map is None else kv_map.data_ptr(), out.data_ptr(),
        None if opart is None else opart.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if lse_out is None else lse_out.data_ptr(), int(partial),
        DTYPES[q.dtype], KV_DTYPES[k.dtype], B, S, H, Hk, D,
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale),
        1.0 if kv_scale is None else float(kv_scale),
        chunk, n_split, n_hb, min(_cap(D), H), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return (out, lse_out) if partial else out


decode_attention.launches = 0
