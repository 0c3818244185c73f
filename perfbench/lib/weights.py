"""The weights, made by the benchmark from ``--seed``.

Leaves are named and laid out as the published model has them (its real
heads only), ``x @ w`` for a matrix. Every matrix is drawn in one call to
``normal_`` on one flat buffer in the type the configuration serves it
in, on the given device, and then scaled by 1/sqrt(its input width); the
norm gains are ones in float32. The same seed, sizes and device give the
same values, so the reference draws them again rather than reading the
program's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .counts import dims


def leaf_specs(cfg: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...],
                                                  Optional[float]]]:
    """(name, shape, std) of every leaf; std None for a norm gain."""
    L, d, H, Hkv, hd, ff, V = dims(cfg)
    out = [("embed", (V, d), 1 / math.sqrt(d))]
    for layer in range(L):
        p = f"layers.{layer}."
        out += [(p + "ln1", (d,), None),
                (p + "wq", (d, H * hd), 1 / math.sqrt(d)),
                (p + "wk", (d, Hkv * hd), 1 / math.sqrt(d)),
                (p + "wv", (d, Hkv * hd), 1 / math.sqrt(d)),
                (p + "wo", (H * hd, d), 1 / math.sqrt(H * hd)),
                (p + "ln2", (d,), None),
                (p + "wg", (d, ff), 1 / math.sqrt(d)),
                (p + "wi", (d, ff), 1 / math.sqrt(d)),
                (p + "wd", (ff, d), 1 / math.sqrt(ff))]
    out += [("ln_f", (d,), None), ("unembed", (d, V), 1 / math.sqrt(d))]
    return out


def dtype_of(cfg: Dict[str, Any]) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg["torch_dtype"]]


@torch.no_grad()
def make(cfg: Dict[str, Any], seed: int, device: Any
         ) -> Dict[str, torch.Tensor]:
    """Every leaf of the configuration, drawn from ``seed`` on
    ``device``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(s) for _, s, std in specs if std is not None)
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=dtype_of(cfg), device=device)
    buf.normal_(generator=g)
    out, off = {}, 0
    for name, shape, std in specs:
        if std is None:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape).mul_(std)
        off += n
    return out
