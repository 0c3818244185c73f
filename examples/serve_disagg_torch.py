"""End-to-end run of the PyTorch port: disaggregated serving with
batched requests on the card.

The port's counterpart of ``examples/serve_disagg.py``: a model with random
weights behind the ``DisaggServer`` orchestrator, which drives the shared
MsFlow runtime at full MFS fidelity (prefix reuse as per-layer-group
Stage-1 flows, queued multi-request prefill batching, per-layer-group P2D
transfers with TTFT deadlines, RMLQ promotion, Algorithm 1 overload
control); decode is slotted continuous batching with real tokens. The
modeled fabric of the smoke config is throttled (``--nic-bw``) to put the
stream into the contended regime the paper studies; the full config keeps
the H100 profile's own NIC unless ``--nic-bw`` is given (its snapshots are
~100 MB, so the smoke throttle would stretch the modeled clock, and the
runtime's ticks with it, over minutes).

The stream is agent-style: a warm wave registers three whole prompts in the
prefix index, then a burst of follow-ups extends them. For an SSM
(``--arch mamba2-1.3b``) or a hybrid (``--arch recurrentgemma-9b``) that is
what snapshot reuse needs: the index keeps the whole per-sequence state at
the end of each prefill (for the hybrid, with the local-attention layers'
last ``window`` keys), and only an exact prefix resumes it. The dense
decoders (``--arch smollm-360m``, ``minitron-8b``, ``starcoder2-3b``,
``qwen1.5-32b``; the last does not fit one card at full depth in bf16) and
the mixtures of experts (``--arch deepseek-moe-16b``: a dense first layer,
then routed and shared experts; ``--arch deepseek-v3-671b``: MLA, whose
latents page, three dense layers, then 256 routed experts, which fits one
card only as its smoke config) and the VLM backbone (``--arch
qwen2-vl-7b``, on text tokens) keep paged K/V, and any page-aligned prefix
resumes. The encoder-decoder (``--arch seamless-m4t-medium``) keeps
snapshots, whose cross K/V an extension reuses: its requests carry seeded
source embeddings, an extension its warm prompt's.

    PYTHONPATH=src python examples/serve_disagg_torch.py --arch mamba2-1.3b
    PYTHONPATH=src python examples/serve_disagg_torch.py \
        --arch recurrentgemma-9b --full
    PYTHONPATH=src python examples/serve_disagg_torch.py \
        --arch deepseek-moe-16b --full
    PYTHONPATH=src python examples/serve_disagg_torch.py \
        --arch starcoder2-3b --full
    PYTHONPATH=src python examples/serve_disagg_torch.py \
        --arch seamless-m4t-medium --full
    PYTHONPATH=src python examples/serve_disagg_torch.py --full   # full width
    # on a machine without a card: --device cpu (plain PyTorch path)
"""
import argparse

import torch

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.core import Stage, make_policy
from repro_torch.device import resolve_device
from repro_torch.launch.serve import agent_requests
from repro_torch.models import build_model
from repro_torch.serving import DisaggConfig, DisaggServer
from repro_torch.simcluster.hw import H100, HW


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true",
                    help="the full published config and 256-token prompts "
                         "instead of the smoke config and 96-token ones")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nic-bw", type=float, default=None,
                    help="modeled NIC bytes/s (small => contention); "
                         "default 2e6 for the smoke config, the H100's own "
                         "with --full")
    ap.add_argument("--slo-scale", type=float, default=3.0,
                    help="SLO = scale x contention-free TTFT; tighten "
                         "(e.g. 1.0) to push Algorithm 1 into pruning")
    args = ap.parse_args()

    cfg = (ARCHS if args.full else SMOKES)[args.arch]
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    nic_bw = args.nic_bw or (H100.nic_bw if args.full else 2e6)
    hw = HW("throttled", flops=H100.flops, hbm_bw=H100.hbm_bw,
            nic_bw=nic_bw, scaleup_bw=H100.scaleup_bw, mfu=H100.mfu)
    shape = (dict(prompt=256, extend=32, fresh=288, max_new=8) if args.full
             else {})
    reqs = agent_requests(cfg, args.requests, seed=args.seed, **shape)

    for pol in ("mfs", "fs", "edf", "karuna"):
        srv = DisaggServer(model, policy=make_policy(pol),
                           cfg=DisaggConfig(n_prefill_units=2, n_pages=512,
                                            decode_capacity=1024, hw=hw,
                                            slo_scale=args.slo_scale))
        res = srv.serve(reqs)
        rt = srv.runtime
        slo = sum(r.met_slo for r in res) / len(res)
        reuse = sum(r.reused_tokens for r in res)
        mean_ttft = sum(r.ttft for r in res) / len(res) * 1e3
        promoted = rt.promoted_count(Stage.P2D)
        print(f"{pol:8s} SLO={slo:6.1%}  mean TTFT={mean_ttft:7.3f} ms  "
              f"reused {reuse:4d} tokens  promoted {promoted:2d} P2D flows  "
              f"pruned {rt.n_pruned} requests", flush=True)
    sample = res[0]
    print(f"\nsample completion rid={sample.rid}: first_token="
          f"{sample.first_token} continuation={sample.tokens}")


if __name__ == "__main__":
    main()
