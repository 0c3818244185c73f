"""Serving engine: prefill / suffix-prefill at B=1 and a slotted
continuous-batching decode loop.

The decode loop keeps one stacked cache tree of fixed capacity
(``max_slots`` sequences x ``capacity`` tokens) and runs ONE batched
``Model.decode_step`` over all slots with **per-slot positions**: RoPE at
each slot's position, the new K/V written at each slot's own offset, and
decode attention with per-slot lengths — what lets sequences of different
lengths share a batch. A local-attention layer's leaves hold ``min(capacity,
window)`` slots as a ring (position p at slot ``p % S``). Slots are recycled
as sequences retire; inactive slots still compute (dead lanes, their writes
kept inside the capacity) and are left out of the results, as a fixed-shape
serving binary would.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.lm import Model
from .paged_kv import is_token_leaf_path, tree_map_with_path

__all__ = ["ServingEngine", "DecodeBatch"]


class ServingEngine:
    """Prefill-side engine for one serving unit."""

    def __init__(self, model: Model):
        self.model = model

    def prefill(self, tokens: np.ndarray,
                prefix_cache: Optional[Any] = None,
                prefix_len: int = 0,
                extra: Optional[Dict[str, Any]] = None
                ) -> Tuple[int, Any, torch.Tensor]:
        """Prefill one request (B=1). Returns (first_token, cache, logits).

        With ``prefix_cache`` the engine computes only the suffix
        ``tokens[prefix_len:]`` — the compute saving of Stage-1 KV reuse.
        """
        tokens = np.asarray(tokens)
        if prefix_cache is not None and prefix_len > 0:
            batch = {"tokens": tokens[None, prefix_len:], **(extra or {})}
            logits, cache = self.model.prefill(batch, caches=prefix_cache,
                                               pos=prefix_len)
        else:
            batch = {"tokens": tokens[None], **(extra or {})}
            logits, cache = self.model.prefill(batch)
        first = int(torch.argmax(logits[0, -1]))
        return first, cache, logits


@dataclass
class _Slot:
    rid: int
    pos: int                 # next write position == current length
    tokens: List[int] = field(default_factory=list)
    max_new: int = 16


class DecodeBatch:
    """Slotted continuous-batching decode engine (one decode unit)."""

    def __init__(self, model: Model, capacity: int = 256, max_slots: int = 8):
        self.model = model
        self.capacity = capacity
        self.max_slots = max_slots
        self.slots: Dict[int, _Slot] = {}
        self._free = list(range(max_slots - 1, -1, -1))
        self._stacked: Optional[Any] = None
        self._tok = np.zeros((max_slots,), np.int64)
        self._pos = np.zeros((max_slots,), np.int64)

    def _leaf_window(self, path) -> int:
        """Local-attention window of the sublayer owning this cache leaf
        (0 = full); paths are (segment, sublayer, "mix", leaf)."""
        return self.model.segments[path[0]].kinds[path[1]][2]

    def _leaf_capacity(self, path) -> int:
        w = self._leaf_window(path)
        return min(self.capacity, w) if w else self.capacity

    def _build(self, example_cache: Any) -> None:
        def empty(path, leaf):
            # [count, 1, S, ...] token leaf -> [count, n, leaf capacity, ...]
            # [count, 1, ...]    state leaf -> [count, n, ...]
            shp = list(leaf.shape)
            shp[1] = self.max_slots
            if is_token_leaf_path(path):
                shp[2] = self._leaf_capacity(path)
            return torch.zeros(shp, dtype=leaf.dtype, device=leaf.device)
        self._stacked = tree_map_with_path(empty, example_cache)

    # ------------------------------------------------------------ lifecycle
    def add(self, rid: int, cache: Any, n_tokens: int, first_token: int,
            max_new: int = 16) -> int:
        """Admit a prefilled sequence; returns its slot id."""
        if not self._free:
            raise RuntimeError("decode batch full")
        if self._stacked is None:
            self._build(cache)
        slot = self._free.pop()

        def write(path, big, small):
            x = small[:, 0]                     # [count, S, ...] / [count, ...]
            if is_token_leaf_path(path):
                n, cap = x.shape[1], big.shape[2]
                if self._leaf_window(path) and n == cap and n_tokens > cap:
                    # a window-cropped leaf holds positions [n_tokens - cap,
                    # n_tokens) at [0, cap): roll it into the ring order
                    # (position p at slot p % cap) that decode writes in
                    x = torch.roll(x, (n_tokens - cap) % cap, dims=1)
                if n > cap:
                    raise ValueError("sequence longer than decode capacity")
                big[:, slot, :n] = x
                big[:, slot, n:] = 0
            else:
                big[:, slot] = x
            return big

        tree_map_with_path(write, self._stacked, cache)
        self._tok[slot] = first_token
        self._pos[slot] = n_tokens
        self.slots[slot] = _Slot(rid=rid, pos=n_tokens, tokens=[first_token],
                                 max_new=max_new)
        return slot

    def remove(self, slot: int) -> _Slot:
        s = self.slots.pop(slot)
        self._free.append(slot)
        return s

    # ----------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """One batched decode step for every slot. Returns {rid: new_token}
        for the active ones and retires slots that reached ``max_new`` or
        capacity."""
        if not self.slots:
            return {}
        dev = self.model.device
        logits, self._stacked = self.model.decode_step(
            self._stacked, torch.from_numpy(self._tok[:, None]).to(dev),
            torch.from_numpy(self._pos).to(dev))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        out: Dict[int, int] = {}
        for slot, meta in list(self.slots.items()):
            t = int(nxt[slot])
            meta.tokens.append(t)
            meta.pos += 1
            out[meta.rid] = t
            self._tok[slot] = t
            self._pos[slot] = meta.pos
            if len(meta.tokens) >= meta.max_new or meta.pos >= self.capacity - 1:
                self.remove(slot)
        return out

    @property
    def n_active(self) -> int:
        return len(self.slots)
