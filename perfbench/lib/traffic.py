"""The one traffic generator: every mix is a data file under ``traffic/``
that this module reads.

Every seed gets the same multiset of sizes and gaps; the seed decides
their order and the token ids. So two seeds ask for the same work and
differ in how it lines up, which keeps the spread of a metric from seed
to seed close to its spread from run to run. Sizes are stratified
quantiles of the mix's distributions, ``(i + 0.5) / n`` for ``i < n``,
so ``n`` of them always have the same median and spread.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()


def stratified(dist: Dict[str, Any], n: int) -> List[int]:
    """``n`` integer sizes of ``dist`` (``{"dist": "lognormal", "median",
    "sigma", "min", "max"}``), in ascending order."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    out = []
    for i in range(n):
        z = _NORMAL.inv_cdf((i + 0.5) / n)
        x = dist["median"] * math.exp(dist["sigma"] * z)
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


def exponential_gaps(n: int, total: float) -> List[float]:
    """``n`` stratified quantiles of an exponential distribution, scaled
    so that they sum to ``total``."""
    raw = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    s = sum(raw)
    return [total * r / s for r in raw]


def zipf_counts(n: int, ranks: int, s: float) -> List[int]:
    """``n`` draws split over ``ranks`` in Zipf(s) proportions, by largest
    remainder, so that they sum to ``n``."""
    w = [1.0 / (r + 1) ** s for r in range(ranks)]
    exact = [n * x / sum(w) for x in w]
    counts = [int(math.floor(e)) for e in exact]
    order = sorted(range(ranks), key=lambda r: counts[r] - exact[r])
    for r in order[:n - sum(counts)]:
        counts[r] += 1
    return counts


@dataclass
class Request:
    rid: int
    burst: int
    tokens: np.ndarray
    max_new: int
    prefix_rank: int                 # -1: no shared prefix


@dataclass
class Burst:
    index: int
    due: float                       # seconds after the window opens
    requests: List[Request] = field(default_factory=list)


def request_shapes(mix: Dict[str, Any], n: int):
    """The mix's ``n`` requests as (prefix rank, prompt length, output
    length), a multiset fixed by the mix and ``n`` alone (their pairing
    is drawn once from a fixed stream, never from the seed). A prompt
    that starts with a shared prefix is at least ``min_suffix`` tokens
    longer than the prefix."""
    lengths = stratified(mix["prompt"], n)
    outputs = stratified(mix["output"], n)
    pre = mix.get("prefixes") or {"share": 0.0, "lengths": []}
    n_shared = int(round(pre["share"] * n))
    ranks: List[int] = []
    if n_shared:
        for r, c in enumerate(zipf_counts(n_shared, len(pre["lengths"]),
                                          pre["zipf_s"])):
            ranks += [r] * c
    ranks += [-1] * (n - len(ranks))
    fixed = np.random.default_rng(0)
    ranks = [ranks[i] for i in fixed.permutation(n)]
    outputs = [outputs[i] for i in fixed.permutation(n)]
    shapes = []
    for r, L, o in zip(ranks, lengths, outputs):
        if r >= 0:
            L = max(L, pre["lengths"][r] + pre["min_suffix"])
        shapes.append((r, L, o))
    return shapes


def _blocked_order(values: List[Any], block: int, rng, key=None
                   ) -> List[Any]:
    """``values`` in an order drawn from ``rng`` in which every run of
    ``block`` consecutive items (from the start) holds one item of each
    ``block``-quantile of the values by ``key``: the sorted values are
    dealt into ``block`` groups, each group shuffled, and item i of every
    group goes into the i-th run in a shuffled order."""
    n = len(values)
    if n % block:
        raise ValueError(f"{n} items do not fill runs of {block}")
    order = sorted(range(n), key=(lambda i: key(values[i])) if key
                   else (lambda i: values[i]))
    per = n // block
    groups = [[order[g * per + j] for j in rng.permutation(per)]
              for g in range(block)]
    out = []
    for i in range(per):
        run = [groups[g][i] for g in range(block)]
        out += [values[run[j]] for j in rng.permutation(block)]
    return out


def serve_plan(mix: Dict[str, Any], seed: int, bursts_per_s: float,
               seconds: float, token_hi: int) -> List[Burst]:
    """Bursts of ``mix["burst"]`` requests due over ``[0, seconds)``:
    ``round(bursts_per_s * seconds)`` of them (up to whole runs of
    ``mix["gap_run"]``), the first at 0, their gaps the stratified
    exponential quantiles of that rate scaled to fill the window; token
    ids in ``[0, token_hi)`` from ``seed``, each shared prefix one fixed
    run of ids a seed.

    What lines up with what is kept alike from seed to seed, so that a
    95th percentile over a window of a few dozen bursts measures the
    program and not the draw: the gaps keep one order, fixed by the mix
    (every ``gap_run`` consecutive gaps one of each of as many quantiles),
    which the seed only rotates; and every burst holds one prompt of each
    of ``burst`` quantiles of the prompt lengths and one output of each
    of as many quantiles of the output lengths, the seed drawing which
    ones and pairing them."""
    n_b = max(1, int(round(bursts_per_s * seconds)))
    size = int(mix["burst"])
    run = int(mix.get("gap_run", 1))
    n_b += (-n_b) % run
    gaps = _blocked_order(exponential_gaps(n_b, seconds), run,
                          np.random.default_rng(0))
    rng = np.random.default_rng(seed)
    turn = int(rng.integers(n_b))
    gaps = gaps[turn:] + gaps[:turn]
    shapes = request_shapes(mix, n_b * size)
    prompts = _blocked_order([s[:2] for s in shapes], size, rng,
                             key=lambda s: s[1])
    outputs = _blocked_order([s[2] for s in shapes], size, rng)
    pre = mix.get("prefixes") or {"lengths": []}
    prefixes = [rng.integers(0, token_hi, size=L, dtype=np.int64)
                for L in pre["lengths"]]
    bursts, due = [], 0.0
    for b in range(n_b):
        burst = Burst(index=b, due=due)
        for j in range(size):
            rid = b * size + j
            (r, L), o = prompts[rid], outputs[rid]
            head = prefixes[r] if r >= 0 else np.zeros(0, np.int64)
            tail = rng.integers(0, token_hi, size=L - len(head),
                                dtype=np.int64)
            burst.requests.append(Request(rid=rid, burst=b,
                                          tokens=np.concatenate([head, tail]),
                                          max_new=o, prefix_rank=r))
        bursts.append(burst)
        due += gaps[b]
    return bursts


@dataclass
class PoolEntry:
    tokens: np.ndarray               # the prompt
    max_new: int


def decode_pool(mix: Dict[str, Any], seed: int, token_hi: int,
                capacity: int) -> List[PoolEntry]:
    """``mix["pool"]`` prompts and their output lengths: the stratified
    sizes, paired by a fixed stream and ordered by ``seed``, each output
    cut so that prompt + output stays below ``capacity``."""
    n = int(mix["pool"])
    lengths = stratified(mix["prompt"], n)
    outputs = stratified(mix["output"], n)
    fixed = np.random.default_rng(0)
    outputs = [outputs[i] for i in fixed.permutation(n)]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pool = []
    for i in order:
        L = lengths[i]
        o = min(outputs[i], capacity - 1 - L)
        pool.append(PoolEntry(tokens=rng.integers(
            0, token_hi, size=L, dtype=np.int64), max_new=o))
    return pool


def train_tokens(mix: Dict[str, Any], seed: int, vocab: int,
                 device: Optional[Any] = None):
    """``mix["batches"]`` batches of ``mix["batch"]`` rows of
    ``mix["seq"] + 1`` token ids in ``[0, vocab)``, drawn on ``device``
    from ``seed`` in one call: an int64 tensor [batches, batch, seq + 1].
    Every row differs from every other (checked)."""
    import torch
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    shape = (int(mix["batches"]), int(mix["batch"]), int(mix["seq"]) + 1)
    toks = torch.randint(0, vocab, shape, generator=g, device=device,
                         dtype=torch.int64)
    rows = toks.reshape(-1, shape[-1])
    if torch.unique(rows, dim=0).shape[0] != rows.shape[0]:
        raise ValueError("two training rows drawn alike")
    return toks
