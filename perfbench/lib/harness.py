"""One run of one cell: the context a driver gets, and the result line
assembled from what it recorded."""
from __future__ import annotations

import math
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import spec


@dataclass
class Ctx:
    """What a driver (``drivers/<kind>.py``) is given."""

    cell: str
    cfg: Dict[str, Any]               # the configuration file
    mix: Dict[str, Any]               # the traffic file
    params: Dict[str, Any]            # the cell's file
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = field(default_factory=time.perf_counter)
    #: tests only: called with (point, object) where a driver hands the
    #: program's objects over, to break the timed path underneath
    fault: Optional[Callable[[str, Any], Any]] = None

    def hook(self, point: str, obj: Any) -> Any:
        return obj if self.fault is None else self.fault(point, obj)


def context(bench: Dict[str, Any], cell: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda",
            t_start: Optional[float] = None) -> Ctx:
    w = spec.workload(bench, cell)
    return Ctx(cell=cell, cfg=spec.config(bench, w["config"]),
               mix=spec.traffic(w["traffic"]), params=spec.cell_params(cell),
               seed=seed, seconds=seconds, trace=trace, device=device,
               t_start=time.perf_counter() if t_start is None else t_start)


def checks_of(record: Dict[str, Any], limits: Dict[str, float]
              ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (a number with no limit gets
    an infinite one, printed so, and the run is not correct)."""
    return {k: {"value": v, "limit": limits.get(k, math.inf)}
            for k, v in record["compared"].items()}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and math.isfinite(c["limit"])
        and c["value"] <= c["limit"] for c in checks.values())


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def assemble(bench: Dict[str, Any], ctx: Ctx, record: Dict[str, Any]
             ) -> Tuple[Dict[str, Any], List[str]]:
    """The result line's object and the lines that end standard error:
    the cell's metrics by their readers (a reader that finds nothing is
    left out), the device, and the compared numbers beside their limits,
    last."""
    metrics = {}
    for m in spec.metrics_for(bench, ctx.cell, ctx.trace):
        value = spec.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = checks_of(record, ctx.params.get("limits", {}))
    device = dict(record["device"])
    tr = record.get("trace")
    if ctx.trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    out = {"correct": is_correct(checks), "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": device}
    if ctx.trace and tr is not None:
        out["breakdown"] = tr.breakdown(record["spans"])
    out["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return out, lines
