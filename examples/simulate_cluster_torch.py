"""Large-scale simulation example — the paper's §6.3 methodology at your
fingertips: pick a model, workload and request rate; compare TTFT SLO
attainment across all five policies (+ the clairvoyant LLF oracle ceiling).

The PyTorch port's ``examples/simulate_cluster.py``: the same run through
``repro_torch``'s control plane, with the same arguments and output.
It holds no tensors, so it has no device to pick.

    PYTHONPATH=src python examples/simulate_cluster_torch.py \
        --model dbrx --workload qwen-conv --rps 11 --requests 128
"""
import argparse

from repro_torch.core import make_policy
from repro_torch.simcluster.papermodels import PAPER_MODELS
from repro_torch.simcluster.sim import (ClusterSim, ClusterSpec,
                                        ParallelismSpec)
from repro_torch.simcluster.trace import WORKLOADS, generate_trace

PARALLELISM = {
    "mixtral-8x7b": ParallelismSpec(mode="ep", ep=8),
    "mixtral-8x22b": ParallelismSpec(mode="ep", tp=4, ep=8),
    "dbrx": ParallelismSpec(mode="ep", tp=2, ep=16),
    "grok": ParallelismSpec(mode="ep", tp=4, ep=8),
    "qwen3-coder": ParallelismSpec(mode="ep", tp=1, ep=32),
    "llama3-8b": ParallelismSpec(mode="sp", tp=4, sp=4),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="dbrx", choices=sorted(PAPER_MODELS))
    ap.add_argument("--workload", default="qwen-conv",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--rps", type=float, default=11.0)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    spec = ClusterSpec(model=PAPER_MODELS[args.model],
                       par=PARALLELISM[args.model], n_units=args.units)
    trace = generate_trace(WORKLOADS[args.workload], args.requests,
                           rps=args.rps, seed=args.seed, warmup=16)
    print(f"{args.model} on {args.workload} @ {args.rps} rps, "
          f"{args.requests} requests\n")
    print(f"{'policy':12s} {'SLO':>7s} {'TTFT p50':>10s} {'TTFT p99':>10s} "
          f"{'CCT slow':>9s} {'earliness':>10s} {'pruned':>6s}")
    for pol in ("fs", "sjf", "edf", "karuna", "mfs", "llf-oracle"):
        sim = ClusterSim(spec, make_policy(pol), seed=args.seed)
        s = sim.run(trace).summary()
        print(f"{pol:12s} {s['slo_attainment']:7.1%} "
              f"{s['ttft_p50']*1e3:9.2f}ms {s['ttft_p99']*1e3:9.2f}ms "
              f"{s['cct_slowdown']:9.2f} {s['pos_earliness']:10.4f} "
              f"{s['pruned']:6d}")


if __name__ == "__main__":
    main()
