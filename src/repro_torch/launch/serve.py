"""Serving launcher: disaggregated P/D cluster with MFS-scheduled transfers.

Runs the PyTorch engine (the smoke config by default, the full config with
``--full``) on the card under the DisaggServer orchestrator and reports
per-request TTFT / SLO attainment per scheduling policy.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --full --requests 16 --rps 200 --policy mfs [--policy fs ...]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --full --policy mfs
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --full --policy mfs
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --full --policy mfs
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \
        --full --policy mfs
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --full --policy mfs
    # on a machine without a card: --device cpu (plain PyTorch path)

``--arch`` takes any of the port's ten configs: smollm-360m, minitron-8b,
starcoder2-3b and qwen1.5-32b (dense; qwen1.5-32b does not fit one card at
full depth in bf16, its smoke config serves anywhere), qwen2-vl-7b (the VLM
backbone, served on text tokens), mamba2-1.3b (SSM), recurrentgemma-9b
(hybrid), deepseek-moe-16b and deepseek-v3-671b (mixtures of experts, the
second with MLA; deepseek-v3-671b fits one card only as its smoke config or
cut in depth) and seamless-m4t-medium (encoder-decoder: each request
carries seeded source embeddings, ``src_len_for`` frames of them).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, SMOKES
from ..core import make_policy
from ..device import resolve_device
from ..models.lm import build_model
from ..serving import DisaggConfig, DisaggServer, ServeRequest

__all__ = ["make_requests", "agent_requests", "run", "src_len_for"]


def src_len_for(seq_len: int) -> int:
    """Encoder frames of the stubbed speech frontend for a ``seq_len``-token
    cell, as the JAX package's ``launch/specs.py::_src_len``."""
    return max(16, min(4096, seq_len // 4))


def _sources(cfg, seed: int, src_len: int):
    """Seeded source embeddings [1, src_len, d] for an encoder-decoder's
    requests (None for any other model), from their own generator so that
    the token streams do not depend on them."""
    if not cfg.enc_layers:
        return lambda: None
    rng = np.random.default_rng(seed + 1)
    return lambda: {"src_embeds": rng.normal(
        size=(1, src_len, cfg.d_model)).astype(np.float32)}


def make_requests(cfg, n: int, rps: float, seed: int = 0,
                  reuse_rate: float = 0.5, mean_prompt: int = 48,
                  max_new: int = 4):
    """Synthetic request stream with Zipf-hot shared prefixes (the paper's
    agent-workload shape at toy scale). An encoder-decoder's requests each
    carry their own source of ``src_len_for(mean_prompt)`` frames."""
    rng = np.random.default_rng(seed)
    source = _sources(cfg, seed, src_len_for(mean_prompt))
    prefixes = [rng.integers(0, cfg.vocab, size=(32,)) for _ in range(4)]
    pmf = np.array([1.0 / (i + 1) ** 1.6 for i in range(4)])
    pmf /= pmf.sum()
    gaps = rng.exponential(1.0 / rps, size=n)
    arrivals = np.cumsum(gaps)
    out = []
    for i in range(n):
        ln = int(np.clip(rng.lognormal(np.log(mean_prompt), 0.4), 16, 512))
        if rng.uniform() < reuse_rate:
            pfx = prefixes[rng.choice(4, p=pmf)]
            toks = np.concatenate([pfx, rng.integers(0, cfg.vocab,
                                                     size=(max(1, ln - 32),))])
        else:
            toks = rng.integers(0, cfg.vocab, size=(ln,))
        out.append(ServeRequest(rid=i, arrival=float(arrivals[i]),
                                tokens=toks, max_new=max_new,
                                extra=source()))
    return out


def agent_requests(cfg, n: int, seed: int = 0, prompt: int = 96,
                   extend: int = 12, fresh: int = 44, max_new: int = 4):
    """The agent-style stream of ``examples/serve_disagg.py``: a warm wave
    of three whole ``prompt``-token prompts at 0, 0.05 and 0.10 s, then
    ``n`` requests from 0.15 s at 1 ms gaps, 60% of them a warm prompt
    extended by ``extend`` fresh tokens and the rest ``fresh``-token prompts.
    The extensions resume a whole warm prompt: what an SSM's snapshot cache
    (exact-prefix reuse only) can serve. An encoder-decoder's warm prompts
    and fresh ones each carry their own source of ``src_len_for(prompt)``
    frames, and an extension keeps its warm prompt's."""
    rng = np.random.default_rng(seed)
    source = _sources(cfg, seed, src_len_for(prompt))
    warm = [rng.integers(0, cfg.vocab, size=(prompt,)) for _ in range(3)]
    reqs = [ServeRequest(rid=i, arrival=i * 0.05, tokens=p, max_new=max_new,
                         extra=source())
            for i, p in enumerate(warm)]
    for i in range(n):
        if rng.uniform() < 0.6:
            j = rng.integers(3)
            toks = np.concatenate([warm[j],
                                   rng.integers(0, cfg.vocab, size=(extend,))])
            extra = reqs[j].extra
        else:
            toks = rng.integers(0, cfg.vocab, size=(fresh,))
            extra = source()
        reqs.append(ServeRequest(rid=3 + i, arrival=0.15 + i * 1e-3,
                                 tokens=toks, max_new=max_new, extra=extra))
    return reqs


def run(arch: str, *, smoke: bool = True, device=None, n_requests: int = 16,
        rps: float = 200.0, policies=("mfs",), seed: int = 0,
        n_units: int = 2, verbose: bool = True):
    cfg = (SMOKES if smoke else ARCHS)[arch]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(cfg, device=dev, generator=gen)
    reqs = make_requests(cfg, n_requests, rps, seed)
    summary = {}
    for pol in policies:
        srv = DisaggServer(model, policy=make_policy(pol),
                           cfg=DisaggConfig(n_prefill_units=n_units))
        res = srv.serve(reqs)
        slo = sum(r.met_slo for r in res) / len(res)
        mean_ttft = float(np.mean([r.ttft for r in res]))
        reuse = sum(r.reused_tokens for r in res) / max(
            1, sum(len(r0.tokens) for r0 in reqs))
        summary[pol] = {"slo_attainment": slo, "mean_ttft_ms": mean_ttft * 1e3,
                        "reuse_fraction": reuse}
        if verbose:
            print(f"{pol:10s} slo={slo:6.3f} mean_ttft={mean_ttft * 1e3:8.3f}ms"
                  f" reuse={reuse:.2%}", flush=True)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true",
                    help="the full published config instead of the smoke one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rps", type=float, default=200.0)
    ap.add_argument("--policy", action="append", default=None)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    run(a.arch, smoke=not a.full, device=a.device, n_requests=a.requests,
        rps=a.rps, policies=tuple(a.policy or ["mfs", "fs", "sjf", "edf",
                                               "karuna"]),
        seed=a.seed, n_units=a.units)


if __name__ == "__main__":
    main()
