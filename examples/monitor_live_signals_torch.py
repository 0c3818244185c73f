"""Online monitor-plane walkthrough — live signals while the run is hot.

Runs a small overloaded cluster with the monitor attached and shows the
three things the plane is for:

1. **Live progress** — ``MonitorSpec.sample_every`` fires ``on_sample``
   every N finished requests; the callback reads streaming estimators
   (rolling attainment, throughput, TTFT p99) off the same `Monitor`
   mid-run. `benchmarks/largescale.py --progress` is the same hook.
2. **The signal bus** — after (or during) the run, any signal can be
   read by name: per-link utilization and contended share, per-stage
   slack-loss rates, quantile sketches per SLO class, and the live
   queue/laxity signals the admission detectors consume.
3. **Detectors on the bus** — the ``queue_depth`` admission detector is
   attached to the bus automatically; its trips are byte-identical to
   the legacy in-detector computation (tests/test_monitor.py), so you
   can migrate control loops onto the bus without re-tuning them.

The monitor is strictly passive: run this with ``--monitor-off`` and the
final metrics match exactly.

The PyTorch port's ``examples/monitor_live_signals.py``: the same run through
``repro_torch``'s control plane, with the same arguments and output.
It holds no tensors, so it has no device to pick.

    PYTHONPATH=src python examples/monitor_live_signals_torch.py \
        --rps 48 --requests 150
"""
import argparse

from repro_torch.core import MonitorSpec, make_policy
from repro_torch.core.router import AdmissionSpec, RouterSpec
from repro_torch.simcluster.papermodels import PAPER_MODELS
from repro_torch.simcluster.sim import (ClusterSim, ClusterSpec,
                                        ParallelismSpec)
from repro_torch.simcluster.trace import (ArrivalSpec, WORKLOADS,
                                          generate_trace)

SLO_MIX = {"tight": 0.2, "standard": 0.5, "loose": 0.3}


def _spec(monitor: bool) -> ClusterSpec:
    return ClusterSpec(
        model=PAPER_MODELS["mixtral-8x7b"], n_units=2,
        par=ParallelismSpec(mode="ep", ep=8),
        router=RouterSpec(admission=AdmissionSpec(
            detector="queue_depth",
            detector_kw={"high": 10, "low": 3},
            shed_classes=("loose",))),
        monitor=MonitorSpec(sample_every=25) if monitor else None)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rps", type=float, default=48.0)
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--monitor-off", action="store_true",
                    help="run without the monitor (prints final metrics "
                         "only — compare to verify passivity)")
    args = ap.parse_args()

    trace = generate_trace(
        WORKLOADS["qwen-conv"], args.requests, rps=args.rps, seed=args.seed,
        warmup=12, slo_mix=SLO_MIX,
        arrival=ArrivalSpec(process="mmpp", burst_factor=8.0,
                            burst_frac=0.15, dwell=2.0))
    sim = ClusterSim(_spec(not args.monitor_off), make_policy("mfs"))

    if sim.monitor is not None:
        # 1. live progress: streaming estimators mid-run, on the event clock
        def progress(mon):
            s = mon.snapshot()
            print(f"  [live] done={s['n_done']:4d} shed={s['n_shed']:3d} "
                  f"attain={s['attainment']:.3f} "
                  f"rate={s['done_rate']:.1f}/s "
                  f"ttft_p99={s['ttft_p99']:.3f}s")

        sim.monitor.on_sample = progress

    m = sim.run(trace)
    print(f"final: attainment={m.slo_attainment():.4f} "
          f"admitted={m.admitted_attainment():.4f} shed={len(m.shed)}")
    if sim.monitor is None:
        return

    # 2. read the bus by name
    bus = sim.monitor.bus
    print("\nsignal bus (end of run):")
    for name, key in (("slo.attainment.cum", None),
                      ("throughput.done", None), ("shed.rate", None),
                      ("ttft.p50", "all"), ("ttft.p99", "all"),
                      ("ttft.p99", "tight"),
                      ("queue.requests.cluster", None),
                      ("laxity.debt", None)):
        v = bus.read(name, key)
        label = f"{name}[{key}]" if key is not None else name
        print(f"  {label:28s} = {v:.4f}")

    # worst links by contended share (rolling window)
    top = sorted(((lid, bus.read("link.contended_share", lid))
                  for lid in sim.monitor.links_seen()),
                 key=lambda kv: -kv[1])[:3]
    print("most contended links (rolling contended-share):")
    for lid, share in top:
        util = bus.read("link.util", lid)
        print(f"  link {lid:4d}: contended={share:.3f} util={util:.3f}")

    # 3. the detector rode the bus the whole run
    det = sim.runtime.admission.detector
    print(f"\nadmission detector: bus-backed={det.bus is not None} "
          f"signal={det.bus_signal!r} trips={det.n_trips} "
          f"tripped={det.tripped}")


if __name__ == "__main__":
    main()
