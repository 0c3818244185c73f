"""What the drivers share: the device's bookkeeping, freeing the program's
state before the reference runs, and the served-token check."""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..lib import weights
from ..reference import dense


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def free(device: str) -> None:
    """Let the program's tensors go (the caller has dropped its names)."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def wait_until(t_ns: int) -> None:
    while True:
        left = t_ns - time.perf_counter_ns()
        if left <= 0:
            return
        time.sleep(min(left / 1e9, 0.05))


def sample(n_items: int, longest: int, n: int, seed: int) -> List[int]:
    """``n`` indices of ``n_items``: ``longest`` and the rest drawn from
    ``seed``."""
    rest = [i for i in range(n_items) if i != longest]
    rng = np.random.default_rng(seed)
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[i] for i in take)


def served_gap(cfg: Dict[str, Any], seed: int, device: str,
               seqs: Sequence[Tuple[np.ndarray, Sequence[int]]],
               precision: str = "f32") -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best, over every served token of ``seqs`` ((prompt, the
    tokens served after it) pairs). The reference draws the weights from
    ``seed`` again and runs once over each prompt with its served tokens.
    With ``precision="fp8"`` the served tokens are the control's: at each
    position, the token the float8 reference puts first."""
    dense.exact()
    leaves = weights.make(cfg, seed, device)
    worst = 0.0
    for prompt, served in seqs:
        toks = torch.as_tensor(np.concatenate(
            [np.asarray(prompt), np.asarray(served[:-1], np.int64)]),
            device=device)
        at = list(range(len(prompt) - 1, len(prompt) - 1 + len(served)))
        ref = dense.logits_at(cfg, leaves, toks, at)
        if precision == "f32":
            chosen = torch.as_tensor(list(served), device=device)
        else:
            chosen = dense.logits_at(cfg, leaves, toks, at,
                                     precision).argmax(-1)
        worst = max(worst, dense.widest_gap(ref, chosen))
    return worst


def check_served(record: Dict[str, Any], cfg: Dict[str, Any], seed: int,
                 device: str, finished: Sequence[Tuple[np.ndarray, list]],
                 n: int) -> Dict[str, Any]:
    """Compare a sample of the sequences ``finished`` in the window (the
    longest and ``n - 1`` drawn from ``seed``) with the reference. With
    none finished there is nothing to hold the program to: the run is not
    correct."""
    if not finished:
        record["compared"] = {"logit_gap": float("nan")}
        record["checked"] = []
        return record
    longest = int(np.argmax([len(p) + len(s) for p, s in finished]))
    pick = [finished[i] for i in sample(len(finished), longest, n, seed)]
    record["compared"] = {"logit_gap": served_gap(cfg, seed, device, pick)}
    record["checked"] = pick
    return record
