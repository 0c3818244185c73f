"""Multi-stage Flow (MsFlow) abstraction — §3.1 of the paper.

An MsFlow is the per-layer communication workload of a prefill request. It
consists of three temporally dependent stages:

  * Stage 1 (Initialization)  — KV-cache reuse fetch; implicit deadline;
    blocks the *target* layer's computation (lookahead transfer).
  * Stage 2 (Execution)       — collective communication (all-to-all for EP,
    all-gather/reduce-scatter for SP/TP); implicit deadline; strictly blocks
    the next computation step (RLI = 0).
  * Stage 3 (Completion)      — P2D transfer of the produced KV to the decode
    unit; explicit deadline = the request's TTFT deadline; never blocks
    prefill computation.

This module defines the plain-data flow records shared by the scheduler
(`repro.core`), the network simulator (`repro.netsim`) and the cluster
simulator (`repro.simcluster`). It is control-plane only: no JAX here.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Tuple

__all__ = [
    "Stage",
    "Flow",
    "Coflow",
    "FlowState",
    "new_flow_id",
]

_flow_counter = itertools.count()


def new_flow_id() -> int:
    return next(_flow_counter)


class Stage(IntEnum):
    """MsFlow stage identifiers (paper §3.1 + the decode plane)."""

    KV_REUSE = 1    # Stage 1: initialization — remote reusable KV fetch
    COLLECTIVE = 2  # Stage 2: execution — blocking collective
    P2D = 3         # Stage 3: completion — prefill→decode KV transfer
    D2D = 4         # decode plane: KV migration between decode endpoints
    #                 (load rebalancing); implicit deadline derived from the
    #                 destination's next-token (TPOT) budget
    WB = 5          # KV-reuse plane: writeback/replication of newly produced
    #                 prefix blocks into slower store tiers; loose derived
    #                 deadline — the most deferrable traffic class


class FlowState(IntEnum):
    PENDING = 0     # submitted, not yet permitted to transmit
    ACTIVE = 1      # transmitting (rate assigned by the fluid model)
    DONE = 2
    PRUNED = 3      # demoted to the scavenger class by overload control


@dataclass
class Flow:
    """A single point-to-point transfer.

    ``src``/``dst`` are node ids understood by the topology (host or NIC
    level). ``target_layer`` is the layer whose computation consumes this
    flow's data (L_target in the paper); for Stage 3 flows it is the layer
    that *produced* the data and is used only for promotion granularity.
    """

    fid: int
    rid: int                      # request id
    unit: int                     # serving-unit id that owns the request
    stage: Stage
    size: float                   # bytes
    src: int
    dst: int
    target_layer: int
    n_layers: int                 # depth L of the owning model
    deadline: Optional[float] = None   # absolute; Stage 3 only
    created: float = 0.0

    # --- runtime state (owned by netsim / scheduler) ---
    remaining: float = field(default=-1.0)
    state: FlowState = FlowState.PENDING
    rate: float = 0.0
    started: Optional[float] = None
    finished: Optional[float] = None
    # Scheduler-assigned knobs consumed by the fluid model:
    #   priority_key — lexicographically smaller = more urgent
    #   rate_cap     — optional ceiling (Karuna-style minimal-rate pacing)
    priority_key: Tuple = (0,)
    rate_cap: Optional[float] = None
    # Immutable per-tier fetch ceiling set at submission by the KV store
    # (host-DRAM / pooled-store read path): the fluid model caps the flow at
    # min(rate_cap, tier_cap), so policies may overwrite rate_cap freely.
    tier_cap: Optional[float] = None
    # RMLQ bookkeeping: current discrete level (1 = highest priority, K =
    # lowest, K+1 = scavenger). Promotion is monotone: level only decreases.
    level: int = 10**9
    coflow: Optional[int] = None  # owning coflow id, if any

    def __post_init__(self) -> None:
        if self.remaining < 0:
            self.remaining = float(self.size)

    @property
    def explicit_deadline(self) -> bool:
        return self.deadline is not None

    def __hash__(self) -> int:  # allow set membership
        return self.fid

    def __eq__(self, other) -> bool:
        return isinstance(other, Flow) and other.fid == self.fid


@dataclass
class Coflow:
    """A group of flows that complete together (e.g. one all-to-all phase).

    Completion time of the coflow = max over member completion times. Used
    for Stage 2 collectives and for the per-layer Stage 1/3 flow groups.
    """

    cid: int
    rid: int
    unit: int
    stage: Stage
    layer: int
    flows: list = field(default_factory=list)
    started: Optional[float] = None
    finished: Optional[float] = None

    @property
    def size(self) -> float:
        return sum(f.size for f in self.flows)

    @property
    def remaining(self) -> float:
        return sum(f.remaining for f in self.flows)

    def done(self) -> bool:
        return all(f.state == FlowState.DONE for f in self.flows)
