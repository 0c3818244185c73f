#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Set-up (weights drawn on the card from the
seed, the program built and warmed on the cell's own shapes) is timed as
``setup_s``; then the window runs ``--seconds`` seconds; then what the
timed path produced is checked against the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, read from a device trace of the
window), ``device``, ``breakdown`` (``--trace 1``) and ``checks``, each
compared number beside its limit, also printed as the last lines of
standard error. Exits non-zero with no result line where the card is
missing, where the cell asks for more cards than there are, and where a
module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.lib import harness, spec
    from perfbench.lib.imports import forbidden
    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.context(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    record = spec.driver(ctx.mix["kind"]).run(ctx)
    record["device"].update(platform="gpu",
                            kind=torch.cuda.get_device_name(0),
                            count=chips, power_limit=harness.power_limit())
    out, lines = harness.assemble(bench, ctx, record)
    bad = forbidden()
    if bad:
        print(f"perfbench: modules of JAX or of the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
