"""The benchmark's data, found by name.

``BENCHMARK.json`` sits at the checkout's root. A cell ``<cell>`` has its
parameters in ``workloads/<cell>.json``; a configuration its sizes in the
``file`` its entry names; a traffic mix ``<mix>`` its parameters in
``traffic/<mix>.json`` (whose ``kind`` names the driver under
``drivers/``); a metric ``<metric>`` its reader in ``metrics/<metric>.py``.
Adding any of them adds files and entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict[str, Any]:
    return _json(PB / "traffic" / f"{name}.json")


def cell_params(name: str) -> Dict[str, Any]:
    return _json(PB / "workloads" / f"{name}.json")


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{kind}")


def reader(metric: str) -> ModuleType:
    """The module of ``metrics/<metric>.py`` (a name may hold dots, so it
    is loaded from its file)."""
    path = PB / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: Dict[str, Any], cell: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    ones: those whose ``workloads`` list it, or that have no such list
    (a per-layer one without it: where the cell reports what it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]
