"""Workload traces — Qwen production-derived and Mooncake-style (§6.2/§6.3).

Statistical shape follows the paper's descriptions:
  * QwenA-Conv   — conversation: ~2k-token prompts, ~50% prefix reuse;
  * QwenB-Agent  — agent: ~1k-token prompts, ~65% reuse, many concurrent
                   requests sharing identical hot prefixes (one-to-many
                   victim contention, §6.3);
  * Mooncake-Conv / Mooncake-Agent — same access patterns with long contexts
                   (~15k / ~9k tokens, ~40% / ~65% reuse).

Prompt lengths are lognormal (heavy upper tail — the paper's "small fraction
of tail requests necessitating large KV movements"); prefix popularity is
Zipf so hot blocks concentrate on victim units.

Arrival processes (``ArrivalSpec``) extend the paper's Poisson default to the
regimes related work sweeps (SLOs-Serve's multi-SLO workloads, Ascendra's
dynamic-load prioritisation):

  * ``poisson`` — memoryless, CV = 1 (the paper's large-scale sims);
  * ``gamma``   — i.i.d. Gamma inter-arrivals with a chosen CV > 1
                  (heavy-tailed gaps: clustered arrivals + lulls);
  * ``mmpp``    — 2-state Markov-modulated Poisson process: a quiet state
                  and a burst state whose rate is ``burst_factor``x higher,
                  occupied ``burst_frac`` of the time, with exponentially
                  distributed dwell times (mean episode cycle ``dwell``
                  seconds). Mean rate stays ``rps`` so attainment-vs-rate
                  curves remain comparable across processes.

Multi-tenant SLO classes: an ``slo_mix`` maps class names (``tight`` /
``standard`` / ``loose``, see ``SLO_CLASSES``) to probabilities; sampled
per request and carried as ``Request.slo_scale``, which the runtime uses in
place of the cluster-wide ``slo_scale`` when deriving the TTFT deadline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Request", "WorkloadSpec", "ArrivalSpec", "WORKLOADS",
           "SLO_CLASSES", "generate_trace", "prefix_chain"]


@dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    reuse_len: int
    prefix_id: int
    # hierarchical prefix chain ((node_id, tokens), ...) — the reusable
    # prefix as a path through the workload's prefix tree, so requests
    # sharing ancestors share the chain's leading segments (partial-prefix
    # hits in the KV-reuse plane). Derived deterministically from
    # (prefix_id, reuse_len): no extra RNG draws, traces stay bit-identical.
    prefix_chain: tuple = ()
    # multi-tenant SLO class (0.0 = defer to the cluster-wide slo_scale)
    slo_class: str = "standard"
    slo_scale: float = 0.0
    out_len: int = 0           # decode output tokens (0 = plane samples)
    # filled by the simulator:
    deadline: float = 0.0
    unit: int = -1
    batch: int = -1
    ideal_ttft: float = 0.0
    ttft: Optional[float] = None
    prefill_done: Optional[float] = None
    stalls: float = 0.0


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mean_prompt: int
    reuse_mean: float          # mean fraction of the prompt that is reusable
    reuse_beta: float = 8.0    # Beta concentration for per-request reuse
    sigma: float = 0.6         # lognormal shape for prompt lengths
    n_prefixes: int = 64
    zipf_a: float = 1.2        # prefix popularity skew (agent = hotter)
    max_prompt: int = 0        # 0 = 8x mean
    mean_out: int = 256        # decode output length (lognormal mean)
    out_sigma: float = 0.8     # lognormal shape for output lengths
    max_out: int = 0           # 0 = 8x mean_out
    # prefix-tree shape for the KV-reuse plane: prefix ``p``'s reusable
    # tokens follow its lineage root->...->p (parent(p) = (p-1)//branch);
    # every ancestor contributes ``chain_node_tokens`` tokens, the leaf
    # takes the remainder — so siblings share exactly their ancestors'
    # token spans (partial-prefix hits)
    chain_branch: int = 4
    chain_node_tokens: int = 512


@dataclass(frozen=True)
class ArrivalSpec:
    """Arrival-process shape at a fixed mean rate (``rps`` stays the knob)."""

    process: str = "poisson"   # poisson | gamma | mmpp
    cv: float = 2.0            # gamma: inter-arrival coefficient of variation
    burst_factor: float = 8.0  # mmpp: burst-state rate / quiet-state rate
    burst_frac: float = 0.1    # mmpp: long-run fraction of time in burst
    dwell: float = 4.0         # mmpp: mean seconds per quiet+burst cycle


#: per-request SLO budget multipliers over the calibration base (tenant mix)
SLO_CLASSES: Dict[str, float] = {"tight": 1.5, "standard": 3.0, "loose": 6.0}


WORKLOADS = {
    "qwen-conv": WorkloadSpec("qwen-conv", mean_prompt=2048, reuse_mean=0.50,
                              zipf_a=1.1),
    "qwen-agent": WorkloadSpec("qwen-agent", mean_prompt=1024, reuse_mean=0.65,
                               zipf_a=1.6, n_prefixes=32),
    "mooncake-conv": WorkloadSpec("mooncake-conv", mean_prompt=15360,
                                  reuse_mean=0.40, zipf_a=1.1, sigma=0.5),
    "mooncake-agent": WorkloadSpec("mooncake-agent", mean_prompt=9216,
                                   reuse_mean=0.65, zipf_a=1.6, sigma=0.5,
                                   n_prefixes=32),
    # Mooncake long-context tail: ~22k-token prompts with a heavy upper
    # tail (sigma 0.9 => the "small fraction of tail requests necessitating
    # large KV movements"), deep shared system prefixes
    # (chain_node_tokens=1024) — the KV-reuse-plane sweep's workload.
    "mooncake-tail": WorkloadSpec("mooncake-tail", mean_prompt=22528,
                                  reuse_mean=0.55, zipf_a=1.4, sigma=0.9,
                                  n_prefixes=48, chain_node_tokens=1024),
}


def prefix_chain(prefix_id: int, reuse_len: int,
                 spec: WorkloadSpec) -> tuple:
    """Hierarchical prefix chain for one request: ``((node, tokens), ...)``.

    The chain walks prefix ``prefix_id``'s lineage from the tree root; each
    ancestor contributes exactly ``spec.chain_node_tokens`` tokens and the
    leaf absorbs whatever of ``reuse_len`` remains, so two prefixes with a
    common ancestor share identical leading (node, tokens) spans — which
    the block-granular KV store turns into partial-prefix hits. Pure
    function of already-sampled trace fields: adding chains changes no RNG
    draw, so fixed-seed traces stay bit-identical.
    """
    lineage = []
    p = int(prefix_id)
    while True:
        lineage.append(p)
        if p <= 0:
            break
        p = (p - 1) // max(spec.chain_branch, 2)
    lineage.reverse()
    out = []
    left = int(reuse_len)
    for i, q in enumerate(lineage):
        last = i == len(lineage) - 1
        t = left if last else min(spec.chain_node_tokens, left)
        if t <= 0:
            break
        out.append((q, t))
        left -= t
    return tuple(out)


# ------------------------------------------------------------ arrival draws
def _gaps_poisson(rng: np.random.Generator, rps: float, n: int) -> np.ndarray:
    return rng.exponential(1.0 / rps, size=n)


def _gaps_gamma(rng: np.random.Generator, rps: float, n: int,
                cv: float) -> np.ndarray:
    """Gamma inter-arrivals: shape k = 1/cv^2 keeps the mean at 1/rps while
    setting the coefficient of variation to ``cv`` (cv=1 == Poisson)."""
    k = 1.0 / (cv * cv)
    return rng.gamma(shape=k, scale=1.0 / (rps * k), size=n)


def _arrivals_mmpp(rng: np.random.Generator, rps: float, n: int,
                   spec: ArrivalSpec) -> np.ndarray:
    """2-state MMPP arrivals. Quiet rate r0 and burst rate f*r0 are solved
    from the long-run mean ``rps = (1-p)*r0 + p*f*r0`` so burstiness is a
    pure *shape* change; state dwell times are exponential with means
    ``dwell*(1-p)`` (quiet) and ``dwell*p`` (burst)."""
    p, f = spec.burst_frac, spec.burst_factor
    r0 = rps / (1.0 - p + p * f)
    rates = (r0, f * r0)
    dwells = (max(spec.dwell * (1.0 - p), 1e-9), max(spec.dwell * p, 1e-9))
    out = np.empty(n)
    t, i = 0.0, 0
    state = 0                                  # start quiet
    state_end = rng.exponential(dwells[state])
    while i < n:
        gap = rng.exponential(1.0 / rates[state])
        if t + gap < state_end:
            t += gap
            out[i] = t
            i += 1
        else:                                  # switch state, keep the clock
            t = state_end
            state = 1 - state
            state_end = t + rng.exponential(dwells[state])
    return out


def generate_trace(spec: WorkloadSpec, n_requests: int, rps: float,
                   seed: int = 0, warmup: int = 0,
                   arrival: Optional[ArrivalSpec] = None,
                   slo_mix: Optional[Dict[str, float]] = None,
                   decode_lens: bool = False) -> List[Request]:
    """``n_requests`` requests at mean rate ``rps`` requests/second.

    ``warmup`` extra leading requests are generated and flagged by negative
    rid so callers can exclude them from metrics (the paper clips the first
    512 trace entries as warm-up).

    ``arrival`` selects the arrival process (default Poisson — identical
    draws to the historical generator, so fixed seeds reproduce old traces).
    ``slo_mix`` maps SLO class names from :data:`SLO_CLASSES` to sampling
    probabilities; ``None`` leaves every request on the cluster default.
    ``decode_lens`` samples per-request output lengths (lognormal over
    ``mean_out``/``out_sigma``) into ``Request.out_len`` for decode-plane
    runs — drawn from a *separate* RNG stream so the base trace stays
    bit-identical for a fixed seed whether or not lengths are requested.
    """
    rng = np.random.default_rng(seed)
    total = n_requests + warmup
    arrival = arrival or ArrivalSpec()
    if arrival.process == "poisson":
        arrivals = np.cumsum(_gaps_poisson(rng, rps, total))
    elif arrival.process == "gamma":
        arrivals = np.cumsum(_gaps_gamma(rng, rps, total, arrival.cv))
    elif arrival.process == "mmpp":
        arrivals = _arrivals_mmpp(rng, rps, total, arrival)
    else:
        raise ValueError(f"unknown arrival process {arrival.process!r}")
    mu = np.log(spec.mean_prompt) - spec.sigma ** 2 / 2.0
    lengths = rng.lognormal(mu, spec.sigma, size=total)
    cap = spec.max_prompt or 8 * spec.mean_prompt
    lengths = np.clip(lengths, 64, cap).astype(int)
    a = spec.reuse_mean * spec.reuse_beta
    b = (1.0 - spec.reuse_mean) * spec.reuse_beta
    reuse_frac = rng.beta(a, b, size=total)
    # Zipf over a fixed prefix pool; hot prefixes pile onto few owner units.
    ranks = np.arange(1, spec.n_prefixes + 1, dtype=np.float64)
    pmf = ranks ** (-spec.zipf_a)
    pmf /= pmf.sum()
    prefixes = rng.choice(spec.n_prefixes, size=total, p=pmf)
    if slo_mix:
        unknown = set(slo_mix) - set(SLO_CLASSES)
        if unknown:
            raise ValueError(f"unknown SLO classes {sorted(unknown)}; "
                             f"choose from {sorted(SLO_CLASSES)}")
        names = sorted(slo_mix)
        probs = np.array([slo_mix[c] for c in names], dtype=np.float64)
        probs /= probs.sum()
        classes = [names[j] for j in rng.choice(len(names), size=total, p=probs)]
    else:
        classes = None
    if decode_lens:
        out_rng = np.random.default_rng(seed + 7919)   # independent stream
        mu_o = np.log(spec.mean_out) - spec.out_sigma ** 2 / 2.0
        cap_o = spec.max_out or 8 * spec.mean_out
        out_lens = np.clip(out_rng.lognormal(mu_o, spec.out_sigma, size=total),
                           1, cap_o).astype(int)
    else:
        out_lens = None

    out: List[Request] = []
    for i in range(total):
        rid = i - warmup            # warm-up requests get negative ids
        cls = classes[i] if classes else "standard"
        reuse_len = int(lengths[i] * reuse_frac[i])
        out.append(Request(
            rid=rid,
            arrival=float(arrivals[i]),
            prompt_len=int(lengths[i]),
            reuse_len=reuse_len,
            prefix_id=int(prefixes[i]),
            prefix_chain=prefix_chain(int(prefixes[i]), reuse_len, spec),
            slo_class=cls,
            slo_scale=SLO_CLASSES[cls] if classes else 0.0,
            out_len=int(out_lens[i]) if out_lens is not None else 0,
        ))
    return out
