"""Unified event queue — computation and network events share one timeline.

The paper (§6.1) stresses that Vidur-generated computation events and
flowsim-level network events must be processed "within a single event queue to
ensure correctness"; this is that queue. Events are (time, seq, kind, payload)
with a monotone sequence number for deterministic FIFO tie-breaking, plus an
epoch-based invalidation scheme so stale flow-completion predictions (obsoleted
by a re-allocation) are skipped cheaply instead of being searched and removed.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Optional, Tuple

__all__ = ["EventQueue"]


class EventQueue:
    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self.now = 0.0

    def push(self, t: float, kind: str, payload: Any = None,
             epoch: Optional[int] = None) -> None:
        if t < self.now - 1e-9:
            raise ValueError(f"scheduling into the past: {t} < {self.now}")
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload, epoch))

    def pop(self) -> Optional[Tuple[float, str, Any, Optional[int]]]:
        if not self._heap:
            return None
        t, _, kind, payload, epoch = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, kind, payload, epoch

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
