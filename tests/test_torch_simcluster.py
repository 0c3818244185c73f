"""The port's copy of the cluster simulator held against the JAX package's:
``ClusterSim`` of both packages on the same generated trace (the paper's
mixtral-8x7b, expert-parallel) gives the same metrics for MFS and a
baseline, and the didactic one-link ``run_toy`` the same finish times.
The copies are byte-identical (``tests/test_torch_package.py``); this holds
that they run as the originals do from the port's own imports."""
import dataclasses

import pytest

from repro.core import make_policy as jmake_policy
from repro.core import Stage as JStage
from repro.netsim.toy import make_flow as jmake_flow
from repro.netsim.toy import run_toy as jrun_toy
from repro.simcluster import ClusterSim as JClusterSim
from repro.simcluster import ClusterSpec as JClusterSpec
from repro.simcluster import ParallelismSpec as JParallelismSpec
from repro.simcluster import PAPER_MODELS as JPAPER_MODELS
from repro.simcluster import WORKLOADS as JWORKLOADS
from repro.simcluster import generate_trace as jgenerate_trace
from repro_torch.configs import get_arch
from repro_torch.core import Stage, make_policy
from repro_torch.netsim.toy import make_flow, run_toy
from repro_torch.simcluster import (PAPER_MODELS, WORKLOADS, ClusterSim,
                                    ClusterSpec, ParallelismSpec,
                                    generate_trace)


def _metrics(policy, pkg):
    """One run of ``pkg``'s simulator: 32 requests of the qwen-agent
    workload at 8 requests/s on mixtral-8x7b, EP 8."""
    if pkg == "jax":
        spec = JClusterSpec(model=JPAPER_MODELS["mixtral-8x7b"],
                            par=JParallelismSpec(mode="ep", ep=8))
        trace = jgenerate_trace(JWORKLOADS["qwen-agent"], n_requests=32,
                                rps=8.0, seed=0, warmup=8)
        return trace, JClusterSim(spec, jmake_policy(policy), seed=0).run(
            trace)
    spec = ClusterSpec(model=PAPER_MODELS["mixtral-8x7b"],
                       par=ParallelismSpec(mode="ep", ep=8))
    trace = generate_trace(WORKLOADS["qwen-agent"], n_requests=32, rps=8.0,
                           seed=0, warmup=8)
    return trace, ClusterSim(spec, make_policy(policy), seed=0).run(trace)


@pytest.mark.parametrize("policy", ["mfs", "fs"])
def test_cluster_sim_metrics_equal_jax(policy):
    trace, got = _metrics(policy, "torch")
    jtrace, want = _metrics(policy, "jax")
    assert [dataclasses.asdict(r) for r in trace] == \
        [dataclasses.asdict(r) for r in jtrace]
    assert got.summary() == want.summary()
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    # coflow ids come from each package's own id counter
    for m in (g, w):
        for c in m["coflows"]:
            c.pop("cid")
    assert g == w
    assert got.summary()["n"] == 32


@pytest.mark.parametrize("policy", ["fs", "sjf", "edf", "mfs"])
def test_run_toy_finish_times_equal_jax(policy):
    """The paper's Fig 6 pair (a collective blocking layer 2, a P2D flow
    with a loose deadline) on one link."""
    flows = [make_flow(Stage.COLLECTIVE, size=2.0),
             make_flow(Stage.P2D, size=1.0, deadline=10.0)]
    jflows = [jmake_flow(JStage.COLLECTIVE, size=2.0),
              jmake_flow(JStage.P2D, size=1.0, deadline=10.0)]
    got = run_toy(flows, make_policy(policy))
    want = jrun_toy(jflows, jmake_policy(policy))
    assert [got[f.fid] for f in flows] == [want[f.fid] for f in jflows]


def test_get_arch_resolves_the_paper_models():
    assert get_arch("mixtral-8x7b") is PAPER_MODELS["mixtral-8x7b"]
    assert get_arch("qwen1.5-32b").n_layers == 64
    with pytest.raises(KeyError):
        get_arch("no-such-model")
