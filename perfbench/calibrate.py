#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and the control's over a few, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 101 102 ... [--control 3] [--out FILE]

For each seed the cell runs as ``run.py`` runs it (a shorter window is
enough: the numbers compared come from what the window finished) and
prints its compared numbers and end-to-end metrics. The control is the
reference in the program's place one precision below (float8 products
for a bf16 configuration): for a served model, at every position of the
same checked prompts and tokens, the gap of the token the float8
reference puts first; for training, the float8 reference's three steps
held to the float32 reference's by the same numbers. The benchmark's own
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control(ctx, record):
    from perfbench.drivers import common, train
    from perfbench.lib import traffic
    if ctx.mix["kind"] == "train":
        batches = traffic.train_tokens(ctx.mix, ctx.seed,
                                       ctx.cfg["vocab_size"], ctx.device)
        batches = batches[:ctx.params["checked_steps"]]
        ref = train.reference(ctx.cfg, ctx.seed, batches, ctx.device)
        low = train.reference(ctx.cfg, ctx.seed, batches, ctx.device, "fp8")
        return train.compare(low, ref)
    return {"logit_gap": common.served_gap(ctx.cfg, ctx.seed, ctx.device,
                                           record["checked"], "fp8")}


def stats(record):
    """Percentiles beside the metrics, to choose which tail a cell can
    hold steady."""
    from perfbench.lib.stats import percentile
    out = {}
    for kind in ("serve", "decode"):
        s = record.get(kind)
        if not s:
            continue
        for q in (50, 90, 95, 99):
            out[f"gap_p{q}_ms"] = percentile(s["gaps_s"], q) * 1e3
        if kind == "serve":
            for q in (50, 90, 95):
                out[f"ttft_p{q}_ms"] = percentile(s["ttft_s"], q) * 1e3
            out["max_lag_s"] = max(s["lag_s"], default=0.0)
            out["unstarted"] = s["unstarted"]
        out["gaps"] = len(s["gaps_s"])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="run the control on the first N seeds")
    ap.add_argument("--fault", choices=("half_batch", "state_unchanged",
                                        "token_altered"), default=None,
                    help="plant a fault underneath the timed path")
    ap.add_argument("--rate", type=float, default=None,
                    help="a serving cell's bursts a second in place of its "
                         "file's: run a few rates to find the highest the "
                         "server sustains (no burst left unstarted, the "
                         "largest lag no longer than a burst's service)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from perfbench import faults
    from perfbench.lib import harness, spec
    bench = spec.benchmark()
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        ctx = harness.context(bench, args.workload, seed, args.seconds, False)
        if args.rate is not None:
            ctx.params = dict(ctx.params, bursts_per_s=args.rate)
        if args.fault == "token_altered":
            ctx.fault = faults.token_altered(ctx.cfg["vocab_size"])
        elif args.fault:
            ctx.fault = getattr(faults, args.fault)
        record = spec.driver(ctx.mix["kind"]).run(ctx)
        record["device"].update(platform="gpu", kind="", count=1)
        res, _ = harness.assemble(bench, ctx, record)
        row = {"seed": seed, "fault": args.fault,
               "compared": record["compared"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "peak": record["device"]["memory_peak_bytes"],
               "readings": record.get("readings"), "stats": stats(record)}
        if i < args.control:
            t = time.perf_counter()
            row["control"] = control(ctx, record)
            row["control_s"] = time.perf_counter() - t
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
