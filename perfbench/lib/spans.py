"""The program's own spans and counters over a traced decode window.

``repro_torch.tracing`` records while a ``torch.profiler`` session is
active, so the ``--trace 1`` window turns it on. A program without that
module, or a run without a trace, gives no reading: ``decode_window`` is
then None and each reader of this file leaves its metric out.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

from .trace import HostSpans

STEP = "engine.step"
DISPATCH = "model.decode_step"
SYNC = "engine.sync"
KERNEL = "kernel.decode_attention"
SYNCS = "host_syncs"


class Window:
    """The recorder's spans, by name, and ``host_syncs`` bumps inside a
    window."""

    def __init__(self, spans: List[Any], syncs: int) -> None:
        self.syncs = syncs
        self.by_name: Dict[str, List[Any]] = defaultdict(list)
        for s in spans:
            self.by_name[s.name].append(s)
        self.steps = self.by_name[STEP]

    def total_ns(self, name: str) -> int:
        return sum(s.t1_ns - s.t0_ns for s in self.by_name[name])

    def per_step_ms(self, name: str) -> float:
        return self.total_ns(name) / 1e6 / len(self.steps)

    def host_spans(self, name: str) -> HostSpans:
        """The spans ``name`` as the device trace labels its gaps with."""
        hs = HostSpans()
        for s in self.by_name[name]:
            hs.add(name, s.t0_ns, s.t1_ns)
        return hs


def decode_window(record: Dict[str, Any]) -> Optional[Window]:
    """The program's spans and ``host_syncs`` within the traced window of
    a decode run, or None (no trace, no recorder in the program, or no
    step recorded in the window)."""
    tr = record.get("trace")
    if tr is None or "decode" not in record:
        return None
    try:
        from repro_torch.tracing import REC
    except ImportError:
        return None
    w = Window(REC.spans(tr.t0_ns, tr.t1_ns),
               REC.counted(SYNCS, tr.t0_ns, tr.t1_ns))
    return w if w.steps else None
