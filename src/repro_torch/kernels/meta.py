"""The kernels on the meta device: each wrapper (and each autograd
Function's backward) given meta tensors returns outputs of its kernel's
shapes and dtypes and launches nothing, computes nothing, and is not the
plain version (``rglru_scan``'s plain version loops over T, which is
524288 in the dry run's ``long_500k``). CUDA tensors still launch or
raise; CPU tensors still take the plain version.

Each meta branch adds the operations its kernel would do, the count behind
its bound (``PERF.md`` §6: the visible (query, key) pairs for attention,
every slot of a decode cache, the scans' recurrence), to ``FLOPS`` by
kernel name: ``launch.dryrun`` adds them to what
``torch.utils.flop_counter.FlopCounterMode`` counts of the step's other
operations.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["FLOPS", "count", "zero", "empty", "visible_pairs"]

#: operations the meta branches stood for since ``zero()``, by kernel
FLOPS: Dict[str, float] = {}


def count(name: str, flops: float) -> None:
    FLOPS[name] = FLOPS.get(name, 0.0) + float(flops)


def zero() -> None:
    FLOPS.clear()


def empty(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def visible_pairs(T: int, S: int, *, causal: bool, window: int,
                  q_offset: int) -> int:
    """The (query, key) pairs of ``ref.attention_mask(T, S, ...)`` that are
    True, counted row by row without the mask: query row i at position
    ``p = i + q_offset`` sees keys ``[max(0, p - window + 1), min(S - 1,
    p)]`` (the upper end ``S - 1`` without ``causal``, the lower 0 without
    ``window``)."""
    p = torch.arange(T, dtype=torch.int64) + q_offset
    hi = p.clamp(max=S - 1) if causal else torch.full_like(p, S - 1)
    lo = (p - window + 1).clamp(min=0) if window else torch.zeros_like(p)
    return int((hi - lo + 1).clamp(min=0).sum())
