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

Every step of a batch therefore issues the same operations on the same
addresses: on one CUDA device (``graphable``) the batch captures its decode
step once, with the argmax, as a CUDA graph over static input and output
buffers, and replays it on every later step, so the host launches one graph
instead of each operation of the model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.lm import Model
from ..tracing import REC, on, syncs
from .paged_kv import is_token_leaf_path, tree_map_with_path

__all__ = ["ServingEngine", "DecodeBatch", "leaf_slots", "admit_leaf",
           "graphable"]


def graphable(model: Model) -> bool:
    """Whether ``DecodeBatch`` replays ``model``'s decode step as a CUDA
    graph: the model lives on a CUDA device and on one rank (no mesh, or a
    mesh of one rank, which runs the same operations). The CPU and the meta
    device have no graphs, and a mesh's collectives cannot be captured:
    there the step runs eagerly."""
    mesh = model.ctx.mesh
    return model.device.type == "cuda" and (
        mesh is None or math.prod(mesh.shape.values()) == 1)


def _window(model: Model, path) -> int:
    """The local-attention window of the sublayer owning the cache leaf at
    ``path`` ((segment, sublayer, ...)); 0 for a full layer."""
    return model.segments[path[0]].kinds[path[1]][2]


def leaf_slots(model: Model, path, capacity: int) -> int:
    """The slots a decode cache of ``capacity`` gives the token leaf at
    ``path``: ``min(capacity, window)`` for a local-attention layer's
    ring, ``capacity`` for a full layer."""
    window = _window(model, path)
    return min(capacity, window) if window else capacity


def admit_leaf(model: Model, path, leaf: torch.Tensor, n_tokens: int,
               capacity: int) -> torch.Tensor:
    """A prefill's cache leaf ``[count, B, ...]`` of ``n_tokens`` positions
    as a decode cache of ``capacity`` slots holds it: a token leaf
    (``is_token_leaf_path``) over its ``leaf_slots`` S, a window-cropped
    one (positions [n_tokens - S, n_tokens) at [0, S)) rolled into the
    ring order that decode writes in (position p at slot ``p % S``), then
    zeros after its positions; a state leaf as it is. Raises where a token
    leaf holds more positions than its slots."""
    if not is_token_leaf_path(path):
        return leaf
    n, S = leaf.shape[2], leaf_slots(model, path, capacity)
    if n > S:
        raise ValueError("sequence longer than decode capacity")
    if _window(model, path) and n == S and n_tokens > S:
        leaf = torch.roll(leaf, (n_tokens - S) % S, dims=2)
    return torch.nn.functional.pad(leaf, (0, 0) * (leaf.dim() - 3)
                                   + (0, S - n))


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
    """Slotted continuous-batching decode engine (one decode unit).

    Graphed (``graphable``), the batch holds its CUDA graph, and the
    graph's private memory pool, for as long as the batch lives: one
    step's intermediates (the logits, and for a MoE decode the gathered
    expert weights, ~5.5 GB for deepseek-v3 at 8 slots on the H100). Each
    decode unit on a card reserves its own such pool."""

    def __init__(self, model: Model, capacity: int = 256, max_slots: int = 8):
        self.model = model
        self.capacity = capacity
        self.max_slots = max_slots
        self.slots: Dict[int, _Slot] = {}
        self._free = list(range(max_slots - 1, -1, -1))
        self._stacked: Optional[Any] = None
        self.graphed = graphable(model)
        # the step's inputs: host tensors that ``_tok`` and ``_pos`` view
        # (pinned where graphed, so that the copies in need not block) and
        # the buffers on the model's device that every step reads
        pin, dev = self.graphed, model.device
        self._tok_h = torch.zeros((max_slots, 1), dtype=torch.int64,
                                  pin_memory=pin)
        self._pos_h = torch.zeros((max_slots,), dtype=torch.int64,
                                  pin_memory=pin)
        self._tok = self._tok_h.numpy()[:, 0]
        self._pos = self._pos_h.numpy()
        self._tok_d = torch.zeros_like(self._tok_h, device=dev)
        self._pos_d = torch.zeros_like(self._pos_h, device=dev)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        #: the last step's logits at the new position, [max_slots, V]
        self.logits: Optional[torch.Tensor] = None
        self._out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.n_steps = 0          # steps taken; a step's span carries it

    def _build(self, example_cache: Any) -> None:
        def empty(path, leaf):
            # [count, 1, S, ...] token leaf -> [count, n, leaf capacity, ...]
            # [count, 1, ...]    state leaf -> [count, n, ...]
            shp = list(leaf.shape)
            shp[1] = self.max_slots
            if is_token_leaf_path(path):
                shp[2] = leaf_slots(self.model, path, self.capacity)
            return torch.zeros(shp, dtype=leaf.dtype, device=leaf.device)
        self._stacked = tree_map_with_path(empty, example_cache)

    # ------------------------------------------------------------ lifecycle
    def add(self, rid: int, cache: Any, n_tokens: int, first_token: int,
            max_new: int = 16) -> int:
        """Admit a prefilled sequence; returns its slot id."""
        if not self._free:
            raise RuntimeError("decode batch full")
        sp = REC.open("engine.add", rid) if on() else -1
        if self._stacked is None:
            self._build(cache)
        slot = self._free.pop()

        def write(path, big, small):
            big[:, slot] = admit_leaf(self.model, path, small, n_tokens,
                                      self.capacity)[:, 0]
            return big

        tree_map_with_path(write, self._stacked, cache)
        self._tok[slot] = first_token
        self._pos[slot] = n_tokens
        self.slots[slot] = _Slot(rid=rid, pos=n_tokens, tokens=[first_token],
                                 max_new=max_new)
        if sp >= 0:
            REC.close(sp)
        return slot

    def remove(self, slot: int) -> _Slot:
        s = self.slots.pop(slot)
        self._free.append(slot)
        return s

    # ----------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """One batched decode step for every slot. Returns {rid: new_token}
        for the active ones and retires slots that reached ``max_new`` or
        capacity.

        The host writes ``_tok`` and ``_pos`` only after the previous step's
        read of its tokens, which orders the writes after that step's copies
        in. Graphed (``graphable``), the copies in do not block, the first
        step captures the graph (``_capture``) and every later one replays
        it (the caches, which it holds by address, are built once, at the
        first ``add``); else ``Model.decode_step`` runs eagerly.

        Recorded (``tracing``): ``engine.step`` (id: the step's number)
        around ``engine.inputs`` (the copies of the inputs to the device),
        ``model.decode_step`` (the eager call, or the replay),
        ``engine.sync`` (the read of the tokens) and ``engine.retire``; the
        counter ``host_syncs`` takes one for each copy that blocked the host
        (``tracing.syncs``), and ``decode_graph_replays`` one for each
        replay."""
        if not self.slots:
            return {}
        self.n_steps += 1
        rec = on()
        if rec:
            sp = REC.open("engine.step", self.n_steps)
            si = REC.open("engine.inputs")
        tok, pos = self._tok_d, self._pos_d
        tok.copy_(self._tok_h, non_blocking=self.graphed)
        pos.copy_(self._pos_h, non_blocking=self.graphed)
        if rec:
            REC.count("host_syncs", 0 if self.graphed else
                      syncs(self._tok_h, tok) + syncs(self._pos_h, pos))
            REC.close(si)
        if not self.graphed:
            logits, self._stacked = self.model.decode_step(self._stacked,
                                                           tok, pos)
            self.logits = logits[:, -1]
        elif self._graph is None:
            self.logits, nxt_d = self._capture()
        else:
            sd = REC.open("model.decode_step") if rec else -1
            self._graph.replay()
            if sd >= 0:
                REC.count("decode_graph_replays")
                REC.close(sd)
            self.logits, nxt_d = self._out
        if rec:
            si = REC.open("engine.sync")
        if not self.graphed:
            nxt_d = torch.argmax(self.logits, dim=-1)
        nxt_h = nxt_d.cpu()
        nxt = nxt_h.numpy()
        if rec:
            REC.count("host_syncs", syncs(nxt_d, nxt_h))
            REC.close(si)
            si = REC.open("engine.retire")
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
        if rec:
            REC.close(si)
            REC.close(sp)
        return out

    def _capture(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first graphed step: ``Model.decode_step`` runs eagerly (it
        builds and loads the kernels and cuBLAS's handles, and its outputs
        are this step's), then the same call and the argmax are captured,
        on a side stream, into a CUDA graph over ``_tok_d``, ``_pos_d``, the
        caches (written in place) and the outputs ``_out``. The eager call
        stays on the current stream, so that its transient tensors reuse
        that stream's cached memory. A capture runs nothing, so the caches
        take this step's writes once; nor does it wait on the device.
        Returns this step's logits at the new position and its tokens, on
        the device."""
        logits, _ = self.model.decode_step(self._stacked, self._tok_d,
                                           self._pos_d)
        row = logits[:, -1]
        nxt = torch.argmax(row, dim=-1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin()
            try:
                logits, _ = self.model.decode_step(self._stacked,
                                                   self._tok_d, self._pos_d)
                self._out = (logits[:, -1],
                             torch.argmax(logits[:, -1], dim=-1))
            finally:
                graph.capture_end()
        self._graph = graph
        return row, nxt

    @property
    def n_active(self) -> int:
        return len(self.slots)
