"""What the two attention wrappers share: the query-head -> KV-head map,
the plain merge of split-KV partials, and the checks and launch sizes of
the CUDA path.

``kv_map`` (int32 ``[H]``) sends query head ``h`` to stored KV head
``kv_map[h]``, clamped to the stored heads, as the JAX model's
``jnp.minimum(q_to_kv, n_store - 1)``. The kernels read it on the card;
the plain versions expand K/V through it (``expand_kv``) and call the
oracles of ``ref.py``.

Split-KV: a row's visible keys are cut into chunks; chunk ``c`` gives the
row's output normalised over its own keys, ``o_c``, and the base-2
log-sum-exp of its scores, ``lse_c`` (``-inf`` for a chunk that sees no
key). ``merge_partials`` is the plain version of the combine kernel in
``csrc/attn_split.cuh``.

``attn_merge`` is that combine launched on its own (``csrc/attn_merge.cu``)
to merge the partials of a sequence-sharded decode, one a rank of the model
axis (``models.blocks``): a CPU tensor goes to ``merge_partials``, a CUDA
tensor launches the kernel or raises; ``attn_merge.launches`` counts the
calls that launched.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, meta

__all__ = ["expand_kv", "merge_partials", "attn_merge", "check_kv_map",
           "aligned", "sm_count", "DTYPES"]

#: dtypes the attention kernels take, by their code in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def expand_kv(x: torch.Tensor, kv_map: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """[B,S,Hk,D] -> [B,S,H,D] through ``kv_map`` (values clamped to
    ``[0, Hk)``); ``x`` itself without a map."""
    if kv_map is None:
        return x
    idx = kv_map.to(device=x.device, dtype=torch.long).clamp(0, x.shape[2] - 1)
    return x.index_select(2, idx)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Merge split-KV partials. o: [n, R, D] (each chunk's output,
    normalised over its keys); lse: [n, R] base-2 log-sum-exp, ``-inf``
    for an empty chunk (whose ``o`` is ignored). Returns [R, D] float32;
    a row whose every chunk is empty gives 0."""
    m = lse.max(0).values                                    # [R]
    w = torch.exp2(lse - torch.where(torch.isinf(m), 0.0, m))  # empty -> 0
    o = torch.where(torch.isinf(lse)[..., None], 0.0, o.float())
    den = w.sum(0)
    num = (w[..., None] * o).sum(0)
    return torch.where(den[:, None] > 0, num / den.clamp(min=1e-30)[:, None],
                       0.0)


def _merge_lib() -> ctypes.CDLL:
    lib = _build.load("attn_merge")
    fn = lib.attn_merge
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, ctypes.c_longlong, I, P]
        fn.restype = ctypes.c_int
    return lib


def attn_merge(o: torch.Tensor, lse: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``merge_partials`` of o [n, R, D] and lse [n, R] (float32, base 2)
    into [R, D] of ``dtype`` (default float32): the combine kernel on a CUDA
    tensor (D a multiple of 4), the plain version on a CPU one, an output
    of the kernel's shape on a meta one (``kernels.meta``; a weighted sum:
    a multiply-add a partial's element)."""
    dtype = dtype or torch.float32
    if o.device.type == "cpu":
        return merge_partials(o, lse).to(dtype)
    if o.device.type == "meta":
        meta.count("attn_merge", 2.0 * o.numel())
        return meta.empty(*o.shape[1:], dtype=dtype)
    if o.device.type != "cuda":
        raise ValueError(f"attn_merge: no kernel for {o.device}")
    n, R, D = o.shape
    if lse.shape != (n, R) or o.dtype != torch.float32 \
            or lse.dtype != torch.float32 or lse.device != o.device:
        raise ValueError(f"attn_merge: partials {o.dtype} {tuple(o.shape)}, "
                         f"lse {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}; both float32 on one device")
    if D % 4 or dtype not in DTYPES:
        raise ValueError(f"attn_merge: D={D} (a multiple of 4) into "
                         f"{dtype} (float32 or bfloat16)")
    o, lse = aligned(o.contiguous()), lse.contiguous()
    out = torch.empty((R, D), dtype=dtype, device=o.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(o.device).cuda_stream
    err = _merge_lib().attn_merge(o.data_ptr(), lse.data_ptr(),
                                  out.data_ptr(), DTYPES[dtype], n, R, D,
                                  stream)
    if err:
        raise RuntimeError(f"attn_merge kernel launch failed: cudaError "
                           f"{err}")
    attn_merge.launches += 1
    return out


attn_merge.launches = 0


def check_kv_map(name: str, kv_map: Optional[torch.Tensor], H: int,
                 Hk: int, device: torch.device) -> None:
    """Raise unless the map fits a kernel launch: int32 ``[H]`` on the
    device of q (without a map, K/V must hold the H query heads)."""
    if Hk < 1:
        raise ValueError(f"{name}: no stored KV head")
    if kv_map is None:
        if Hk != H:
            raise ValueError(f"{name}: {Hk} stored KV heads for {H} query "
                             "heads need a kv_map")
        return
    if kv_map.shape != (H,) or kv_map.dtype != torch.int32 \
            or kv_map.device != device:
        raise ValueError(f"{name}: kv_map must be int32 [{H}] on {device}, "
                         f"got {kv_map.dtype} {tuple(kv_map.shape)} on "
                         f"{kv_map.device}")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if its rows can be copied 16 bytes at a time (unit stride along
    the last axis, address and other strides multiples of 16 bytes), else a
    contiguous copy."""
    es = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 \
            and all(s * es % 16 == 0 for s in x.stride()[:-1]):
        return x
    return x.contiguous()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
