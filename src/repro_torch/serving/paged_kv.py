"""Paged KV storage + content-addressed prefix index (Mooncake-style reuse).

The PyTorch counterpart of the JAX package's ``serving/paged_kv.py``, with
the same two regimes:

* **Pageable caches** (attention ``k``/``v``) — one pool tensor per
  token-indexed cache leaf, the token axis reshaped to ``(n_pages,
  page_size)``; one page id indexes every pool, pages are
  reference-counted, and any page-aligned prefix boundary is a resume point
  for ``Model.prefill(caches=..., pos=...)``. Boundaries are
  content-addressed by a sha256 chain over token pages, hashed over the same
  int32 bytes as the JAX index, so both give the same matches.
* **Snapshot caches** (per-sequence state) — the whole B=1 cache tree is
  kept, keyed by the exact token prefix.

Cache trees are nested lists and dicts of tensors; the small walkers below
stand in for ``jax.tree_util``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

__all__ = ["PagedStore", "PrefixIndex", "PrefixEntry", "cache_has_state",
           "cache_bytes", "is_token_leaf_path", "tree_leaves_with_path",
           "tree_map_with_path"]

# cache-leaf names with a *decode-token* axis in the stacked prefill layout
# [seg_count, B, S, ...]; everything else is per-sequence state
_TOKEN_LEAVES = {"k", "v", "c", "kr"}

Path = Tuple[Any, ...]


def tree_leaves_with_path(tree: Any, path: Path = ()
                          ) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) pairs of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Path = ()) -> Any:
    """Rebuild ``tree`` with ``fn(path, leaf, *rest_leaves)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def is_token_leaf_path(path: Path) -> bool:
    """Does this stacked-cache leaf have a token axis (axis 2)?"""
    return str(path[-1]) in _TOKEN_LEAVES


def cache_has_state(cache: Any) -> bool:
    """True if any leaf is per-sequence state (forces snapshot storage)."""
    return any(not is_token_leaf_path(p)
               for p, _ in tree_leaves_with_path(cache))


def cache_bytes(cache: Any) -> int:
    """Total bytes of a cache tree (sizes Stage-1/Stage-3 flows)."""
    return sum(x.numel() * x.element_size()
               for _, x in tree_leaves_with_path(cache))


class _Allocator:
    def __init__(self, n_pages: int):
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refs: Dict[int, int] = {}

    def alloc(self, n: int) -> List[int]:
        if len(self.free) < n:
            raise MemoryError(f"paged KV pool exhausted ({n} pages needed, "
                              f"{len(self.free)} free)")
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                del self.refs[p]
                self.free.append(p)

    @property
    def n_free(self) -> int:
        return len(self.free)


class PagedStore:
    """Page pools for every token-indexed leaf of a pageable prefill cache."""

    def __init__(self, page_size: int = 16, n_pages: int = 512):
        self.page_size = page_size
        self.n_pages = n_pages
        self.alloc = _Allocator(n_pages)
        self._pools: Dict[Path, torch.Tensor] = {}
        self._template: Any = None           # tree shape of the caches

    def _ensure_pools(self, cache: Any) -> None:
        if self._template is not None:
            return
        for path, leaf in tree_leaves_with_path(cache):
            if not is_token_leaf_path(path):
                raise ValueError(
                    f"PagedStore got a state leaf {path} — use snapshot "
                    "storage for this architecture")
            shp = list(leaf.shape)
            del shp[1]                               # drop B
            shp[1:2] = [self.n_pages, self.page_size]
            self._pools[path] = torch.zeros(shp, dtype=leaf.dtype,
                                            device=leaf.device)
        self._template = tree_map_with_path(lambda p, x: None, cache)

    def put(self, cache: Any, n_tokens: int) -> List[int]:
        """Write one request's (B=1) stacked prefill cache into fresh pages.

        Returns the page ids (len = ceil(n_tokens / page_size)); the
        trailing partial page is zero-padded.
        """
        self._ensure_pools(cache)
        ps = self.page_size
        n_pg = -(-n_tokens // ps)
        pages = self.alloc.alloc(n_pg)
        for path, leaf in tree_leaves_with_path(cache):
            x = leaf[:, 0]                           # [count, S, feat...]
            if x.shape[1] < n_tokens:
                raise ValueError(f"leaf {path} shorter than n_tokens — "
                                 "window-cropped caches are snapshot-only")
            pool = self._pools[path]
            x = x[:, :n_tokens]
            pad = n_pg * ps - n_tokens
            if pad:
                x = torch.cat([x, x.new_zeros((x.shape[0], pad)
                                              + tuple(x.shape[2:]))], 1)
            x = x.reshape(x.shape[0], n_pg, ps, *x.shape[2:])
            idx = torch.tensor(pages, dtype=torch.long, device=pool.device)
            pool[:, idx] = x.to(pool.dtype)
        return pages

    def _rebuild(self, pages: Sequence[int], off: int, n: int) -> Any:
        idx = torch.tensor(list(pages), dtype=torch.long)

        def take(path, _):
            pool = self._pools[path]
            x = pool.index_select(1, idx.to(pool.device))
            x = x.reshape(x.shape[0], -1, *x.shape[3:])[:, off:off + n]
            return x[:, None]                         # restore B=1
        return tree_map_with_path(take, self._template)

    def gather(self, pages: Sequence[int], n_tokens: int) -> Any:
        """Rebuild a (B=1) prefix cache tree from pages."""
        if self._template is None:
            raise RuntimeError("gather before any put")
        return self._rebuild(pages, 0, n_tokens)

    def gather_slice(self, pages: Sequence[int], start: int, end: int) -> Any:
        """Rebuild a (B=1) cache tree covering tokens ``[start, end)`` only;
        concatenating consecutive slices along the token axis reproduces
        :meth:`gather` exactly."""
        if self._template is None:
            raise RuntimeError("gather_slice before any put")
        if not 0 <= start < end:
            raise ValueError(f"bad token slice [{start}, {end})")
        ps = self.page_size
        p0, p1 = start // ps, -(-end // ps)
        return self._rebuild(list(pages)[p0:p1], start - p0 * ps, end - start)

    def release(self, pages: Sequence[int]) -> None:
        self.alloc.release(pages)

    def retain(self, pages: Sequence[int]) -> None:
        self.alloc.retain(pages)


# =====================================================================
# Prefix index
# =====================================================================
@dataclass
class PrefixEntry:
    pages: List[int]                 # empty for snapshot entries
    n_tokens: int
    owner_unit: int
    snapshot: Optional[Any] = None   # full cache tree (snapshot regime)
    bytes: int = 0                   # transfer size of this prefix
    hits: int = 0


def _page_hash_chain(tokens: np.ndarray, page_size: int) -> List[bytes]:
    out: List[bytes] = []
    h = hashlib.sha256()
    for i in range(len(tokens) // page_size):
        h.update(np.ascontiguousarray(
            tokens[i * page_size:(i + 1) * page_size],
            dtype=np.int32).tobytes())
        out.append(h.digest())
    return out


def _exact_hash(tokens: np.ndarray) -> bytes:
    return hashlib.sha256(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).digest()


class PrefixIndex:
    """Content-addressed map: token-prefix -> reusable cached prefix."""

    def __init__(self, store: PagedStore):
        self.store = store
        self._paged: Dict[bytes, PrefixEntry] = {}
        self._snap: Dict[bytes, PrefixEntry] = {}
        self._snap_lengths: Set[int] = set()

    # ---------------------------------------------------------------- match
    def match(self, tokens: np.ndarray) -> Optional[PrefixEntry]:
        """Longest reusable prefix of ``tokens``."""
        tokens = np.asarray(tokens)
        best: Optional[PrefixEntry] = None
        chain = _page_hash_chain(tokens, self.store.page_size)
        for key in reversed(chain):
            e = self._paged.get(key)
            if e is not None:
                best = e
                break
        for n in sorted(self._snap_lengths, reverse=True):
            if best is not None and n <= best.n_tokens:
                break
            if n > len(tokens):
                continue
            e = self._snap.get(_exact_hash(tokens[:n]))
            if e is not None:
                best = e
                break
        if best is not None:
            best.hits += 1
        return best

    # --------------------------------------------------------------- insert
    def insert_paged(self, tokens: np.ndarray, pages: List[int],
                     owner_unit: int, per_token_bytes: float) -> int:
        """Register every full-page boundary of a pageable cache."""
        tokens = np.asarray(tokens)
        chain = _page_hash_chain(tokens, self.store.page_size)
        added = 0
        for i, key in enumerate(chain):
            if key in self._paged:
                continue
            pg = pages[:i + 1]
            self.store.retain(pg)
            n_tok = (i + 1) * self.store.page_size
            self._paged[key] = PrefixEntry(
                pages=list(pg), n_tokens=n_tok, owner_unit=owner_unit,
                bytes=int(n_tok * per_token_bytes))
            added += 1
        return added

    def insert_snapshot(self, tokens: np.ndarray, cache: Any,
                        owner_unit: int) -> int:
        """Register the end-of-prefill boundary of a snapshot cache."""
        tokens = np.asarray(tokens)
        key = _exact_hash(tokens)
        if key in self._snap:
            return 0
        self._snap[key] = PrefixEntry(
            pages=[], n_tokens=len(tokens), owner_unit=owner_unit,
            snapshot=cache, bytes=cache_bytes(cache))
        self._snap_lengths.add(len(tokens))
        return 1

    # ---------------------------------------------------------------- fetch
    def fetch(self, entry: PrefixEntry) -> Any:
        """Materialise the prefix cache tree for ``Model.prefill``."""
        if entry.snapshot is not None:
            return entry.snapshot
        return self.store.gather(entry.pages, entry.n_tokens)

    def __len__(self) -> int:
        return len(self._paged) + len(self._snap)
