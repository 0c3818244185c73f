"""repro.core — the paper's contribution: MFS multi-stage flow scheduling.

Public surface:
    Stage, Flow, Coflow            — MsFlow abstraction (§3.1)
    MLUConfig, mlu, mlu_level      — explicit-deadline urgency (§4.3)
    rli_level                      — implicit-deadline urgency (§4.4.1)
    RMLQ                           — Reverse Multi-Level Queue (§4.2)
    red_score, sort_by_red         — Robust Effective Deadline (§4.4.2)
    inter_request_schedule         — Algorithm 1 (Appendix B)
    MFSScheduler                   — the full arbiter (§4.5)
    FairShare, SJF, EDF, Karuna    — baselines (§6.3), LLFOracle ceiling
    GroupPlan, StageProfile, StageEmitter — shared stage-emission layer (§3.1)
    DecodePlane, DecodeSpec        — decode plane: pools, TPOT tracking,
                                     D2D KV-migration rebalancing
    KVStore, KVStoreSpec, TierSpec — KV-reuse plane: shared tiered prefix
                                     store, live hits, Stage-WB writebacks
    RouterPolicy, RouterSpec, make_router — router plane: pluggable
                                     cluster-level placement policies
    OverloadDetector, AdmissionSpec — overload-triggered admission control
                                     (shed/defer loose-SLO requests)
    Telemetry, TelemetrySpec       — telemetry plane: lifecycle spans, RMLQ
                                     decision audit, link-contention
                                     attribution, SLO-miss root causes
    Monitor, MonitorSpec, SignalBus — online monitor plane: streaming
                                     estimators over the same probe sites,
                                     live signals for detectors/routers
    Dinic, FlowGraph, disagg_bound — max-flow optimality yardstick
                                     (Helix-style attainment ceiling)
    MsFlowRuntime, RuntimeHost     — shared orchestration runtime (§5)
"""
from .msflow import Stage, Flow, Coflow, FlowState, new_flow_id
from .urgency import MLUConfig, mlu, mlu_level, geometric_thresholds, rli_level
from .rmlq import RMLQ
from .red import red_score, partition_by_max_gap, sort_by_red, BatchRef
from .feasibility import BatchLoad, InterSchedule, inter_request_schedule
from .policies import (
    Policy,
    SchedView,
    FairShare,
    SJF,
    EDF,
    Karuna,
    LLFOracle,
    make_policy,
)
from .arbiter import MFSScheduler
from .stages import (ParallelismSpec, GroupPlan, ChunkSpec, ChunkPlan,
                     StageProfile, PrefillItem, BatchState, StageEmitter)
from .decode import (DecodePoolSpec, DecodeSpec, DecodeSession, DecodePlane,
                     partition_pools)
from .kvstore import (TierSpec, KVStoreSpec, HitSegment, HitPlan, KVStore,
                      kv_route, chain_keys, content_chain)
from .router import (RoutingView, RouterPolicy, KVAffinityRouter,
                     RoundRobinRouter, SessionAffinityRouter,
                     LeastBacklogRouter, register_router, make_router,
                     OverloadDetector, QueueDepthDetector, LaxityDebtDetector,
                     register_detector, make_detector,
                     RouterSpec, AdmissionSpec, AdmissionController)
from .telemetry import (Telemetry, TelemetrySpec, StageLog, FlowSpan,
                        RequestTrace, link_name)
from .monitor import (Monitor, MonitorSpec, SignalBus, FixedBinSketch,
                      RollingWindow, ProbeFanout)
from .maxflow import (Dinic, FlowGraph, fixed_route_rate, disagg_bound,
                      attainment_ceiling)
from .runtime import MsFlowRuntime, RuntimeHost, RuntimeView

__all__ = [
    "Stage", "Flow", "Coflow", "FlowState", "new_flow_id",
    "MLUConfig", "mlu", "mlu_level", "geometric_thresholds", "rli_level",
    "RMLQ",
    "red_score", "partition_by_max_gap", "sort_by_red", "BatchRef",
    "BatchLoad", "InterSchedule", "inter_request_schedule",
    "Policy", "SchedView",
    "FairShare", "SJF", "EDF", "Karuna", "LLFOracle", "make_policy",
    "MFSScheduler",
    "ParallelismSpec", "GroupPlan", "ChunkSpec", "ChunkPlan", "StageProfile",
    "PrefillItem", "BatchState", "StageEmitter",
    "DecodePoolSpec", "DecodeSpec", "DecodeSession", "DecodePlane",
    "partition_pools",
    "TierSpec", "KVStoreSpec", "HitSegment", "HitPlan", "KVStore",
    "kv_route", "chain_keys", "content_chain",
    "RoutingView", "RouterPolicy", "KVAffinityRouter", "RoundRobinRouter",
    "SessionAffinityRouter", "LeastBacklogRouter", "register_router",
    "make_router", "OverloadDetector", "QueueDepthDetector",
    "LaxityDebtDetector", "register_detector", "make_detector",
    "RouterSpec", "AdmissionSpec", "AdmissionController",
    "Telemetry", "TelemetrySpec", "StageLog", "FlowSpan", "RequestTrace",
    "link_name",
    "Monitor", "MonitorSpec", "SignalBus", "FixedBinSketch", "RollingWindow",
    "ProbeFanout",
    "Dinic", "FlowGraph", "fixed_route_rate", "disagg_bound",
    "attainment_ceiling",
    "MsFlowRuntime", "RuntimeHost", "RuntimeView",
]
