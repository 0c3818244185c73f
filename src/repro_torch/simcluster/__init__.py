"""repro.simcluster — Vidur-style event-driven disaggregated-serving simulator."""
from .hw import HW, A100, RTX3090, TPU_V5E
from .trace import Request, WorkloadSpec, WORKLOADS, generate_trace
from .metrics import SimMetrics, CoflowRecord
from .sim import ParallelismSpec, ClusterSpec, ClusterSim
from .papermodels import PAPER_MODELS

__all__ = [
    "HW", "A100", "RTX3090", "TPU_V5E",
    "Request", "WorkloadSpec", "WORKLOADS", "generate_trace",
    "SimMetrics", "CoflowRecord",
    "ParallelismSpec", "ClusterSpec", "ClusterSim",
    "PAPER_MODELS",
]
