"""SLO-miss root-cause example — run the Mooncake long-context tail with
the telemetry plane on, then ask it *why* each policy missed: every missed
request's lost slack is pinned to the flow span with the largest network
excess and its bottleneck link, ranked into a per-policy top-3
(stage, link) table. One missed tight-SLO request's full timeline
(compute spans, per-stage network flows, lifecycle instants) is exported
as Chrome trace-event JSON — open it at ``ui.perfetto.dev``.

The PyTorch port's ``examples/telemetry_root_cause.py``: the same run through
``repro_torch``'s control plane, with the same arguments and output.
It holds no tensors, so it has no device to pick.

    PYTHONPATH=src python examples/telemetry_root_cause_torch.py \
        --rps 16 --requests 120 --trace-out miss_timeline.json
"""
import argparse

from repro_torch.core import TelemetrySpec, make_policy
from repro_torch.core.kvstore import KVStoreSpec, TierSpec
from repro_torch.simcluster.hw import A100, Gb, HW
from repro_torch.simcluster.papermodels import PAPER_MODELS
from repro_torch.simcluster.sim import (ClusterSim, ClusterSpec,
                                        ParallelismSpec)
from repro_torch.simcluster.trace import (ArrivalSpec, WORKLOADS,
                                          generate_trace)

#: the benchmark suite's 16-unit sp Mooncake cluster: 50 Gbps/GPU NIC share
#: so long-context KV movement, not compute, is the binding constraint
HW_50G = HW("a100-50g", flops=A100.flops, hbm_bw=A100.hbm_bw,
            nic_bw=50 * Gb, scaleup_bw=A100.scaleup_bw)
STORE = KVStoreSpec(
    block_tokens=256, pooled_nodes=2, wb_deadline_scale=8.0,
    tiers=(TierSpec("hbm", capacity=2e9),
           TierSpec("dram", capacity=4e9, fetch_bw=12e9, scope="unit",
                    writeback=True),
           TierSpec("remote", capacity=64e9, fetch_bw=6.25e9, scope="pooled",
                    writeback=True)))
SLO_MIX = {"tight": 0.2, "standard": 0.5, "loose": 0.3}


def _spec() -> ClusterSpec:
    return ClusterSpec(model=PAPER_MODELS["mixtral-8x7b"], n_units=16,
                       par=ParallelismSpec(mode="sp", sp=4),
                       gpus_per_server=4, topology="fattree",
                       hosts_per_rack=8, layer_groups=8, decode_ratio=0.5,
                       hw=HW_50G, kvstore=STORE, telemetry=TelemetrySpec())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rps", type=float, default=16.0)
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default="miss_timeline.json",
                    help="Chrome trace of one missed tight-SLO request")
    args = ap.parse_args()

    trace = generate_trace(WORKLOADS["mooncake-tail"], args.requests,
                           rps=args.rps, seed=args.seed, warmup=24,
                           arrival=ArrivalSpec(process="mmpp"),
                           slo_mix=SLO_MIX)
    print(f"mooncake-tail @ {args.rps} rps, {args.requests} requests, "
          f"tiered store on, SLO mix {SLO_MIX}\n")

    sample = None
    for pol in ("fs", "sjf", "edf", "karuna", "mfs"):
        sim = ClusterSim(_spec(), make_policy(pol), seed=args.seed)
        s = sim.run(trace).summary()
        tel = sim.telemetry
        rep = tel.slo_miss_report(top=3)
        tight = tel.slo_miss_report(slo_class="tight")
        cov = "n/a" if rep["coverage"] is None else f"{rep['coverage']:.0%}"
        print(f"{pol:8s} attainment={s['slo_attainment']:.1%}  "
              f"missed={rep['n_missed']} (tight={tight['n_missed']})  "
              f"link-attributed={cov}")
        for c in rep["causes"]:
            where = c["link_name"] if c["link"] is not None else c["stage"]
            print(f"         {c['n']:3d}x  {c['stage']:9s} @ {where:12s} "
                  f"slack_lost={c['slack_lost']:7.2f}s")
        share = tel.contended_stage_share()
        if share:
            print("         contended-link bytes: "
                  + "  ".join(f"{st}={v:.0%}" for st, v in share.items()))
        # keep one missed tight request's timeline (prefer the mfs arm's)
        picked = next((r["rid"] for r in tight["requests"]
                       if r.get("link") is not None), None)
        if picked is not None and (sample is None or pol == "mfs"):
            sample = (pol, picked, tel)
        print()

    if sample is not None:
        pol, rid, tel = sample
        tel.save_chrome_trace(args.trace_out, rids={rid})
        bd = tel.ttft_breakdown(rid)
        print(f"wrote {args.trace_out}: rid={rid} ({pol} arm), "
              f"ttft={bd['ttft']:.2f}s = queue {bd['queue']:.2f} "
              f"+ s1 stall {bd['stall_s1']:.2f} + compute {bd['compute']:.2f} "
              f"+ coll wait {bd['coll_wait']:.2f} "
              f"+ p2d tail {bd['p2d_tail']:.2f} "
              f"+ first decode {bd['first_decode']:.2f}")
        print("open it at ui.perfetto.dev (or chrome://tracing)")


if __name__ == "__main__":
    main()
