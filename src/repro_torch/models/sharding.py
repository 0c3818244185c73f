"""Head padding of the parameter layout (the no-mesh part of the JAX
package's ``ShardCtx``).

Query heads and the vocab pad to a multiple of ``HEAD_PAD`` whatever the
device count (``ShardCtx.head_multiple`` with no mesh), so the parameter
layout does not depend on the mesh; padded heads are exact no-ops. A model
axis wider than 16 raises the multiple: that comes with multi-GPU.
"""
from __future__ import annotations

__all__ = ["HEAD_PAD", "pad_to_multiple"]

HEAD_PAD = 16


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
