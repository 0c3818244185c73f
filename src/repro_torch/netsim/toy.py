"""Didactic single-link scenario runner — reproduces the paper's Fig 6/7 and
Table 1/2 examples exactly (used by tests/test_paper_examples.py and
benchmarks.microbench).

All flows share one bottleneck link of unit capacity. The runner drives a
policy through the same submit -> assign -> reallocate -> advance loop the
cluster simulator uses, firing periodic "tick" triggers so deadline-driven
promotion (MFS's MLU ladder) can act between completions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import Stage, new_flow_id
from ..core.msflow import Flow
from ..core.policies import Policy
from .fluid import FluidNet
from .topology import Topology

__all__ = ["OneLink", "ToyView", "run_toy"]


class OneLink(Topology):
    """Every src->dst pair traverses the single link 0."""

    def __init__(self, capacity: float = 1.0):
        super().__init__(2)
        self.capacity = {0: capacity}

    def route(self, src: int, dst: int, fid: int = 0) -> Tuple[int, ...]:
        return (0,)

    def server_of(self, node: int) -> int:
        return node


@dataclass
class ToyView:
    net: FluidNet
    lcurr: int = 0

    @property
    def now(self) -> float:
        return self.net.now

    def bottleneck(self, flow):
        return self.net.bottleneck(flow)

    def mlu_inputs(self, flow, level):
        def protected(o):
            if o.stage != Stage.P2D:
                return True
            return o.level < level
        return self.net.bottleneck_protected(flow, protected)

    def l_curr(self, unit: int) -> int:
        return self.lcurr

    def computing(self, rid: int) -> bool:
        return False          # toy flows re-evaluate on ticks

    def red_rank(self, rid: int) -> int:
        return 0

    def downstream_estimate(self, flow) -> float:
        return 0.0


def make_flow(stage: Stage, size: float, deadline: Optional[float] = None,
              rid: int = 0, target_layer: int = 0) -> Flow:
    return Flow(fid=new_flow_id(), rid=rid, unit=0, stage=stage, size=size,
                src=0, dst=1, target_layer=target_layer, n_layers=4,
                deadline=deadline)


def run_toy(flows: List[Flow], policy: Policy, capacity: float = 1.0,
            tick: float = 0.25, t_max: float = 100.0) -> Dict[int, float]:
    """Run all flows (submitted at t=0) to completion; returns fid->finish."""
    policy.reset()
    net = FluidNet(OneLink(capacity))
    view = ToyView(net)
    for f in flows:
        net.add(f)
        policy.on_flow_submitted(f, view)
    finish: Dict[int, float] = {}
    t = 0.0
    while net.flows and t < t_max:
        policy.assign(list(net.flows.values()), view, ("tick",))
        net.reallocate()
        nxt = net.next_completion()
        t_next = min(t + tick, nxt[0] if nxt else t + tick)
        done = net.advance(t_next)
        for f in done:
            finish[f.fid] = f.finished
            policy.on_flow_completed(f, view)
        t = t_next
    return finish
