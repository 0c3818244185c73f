"""The device trace of a window and the benchmark's own host spans.

``HostSpans`` records labelled intervals on the host clock around the
calls the harness makes into the program. ``DeviceTrace`` runs
``torch.profiler`` over a window (device activity only, unless a span
needs the host's) and reads the profiler's raw events, never building
its per-event Python objects: a serve window has ~10^6 kernels. It gives
the device's busy seconds (the union of its operations), the window's
length, time by operation name, and the idle gaps labelled by the
innermost host span that was open at the gap's middle.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

#: a span label for time the harness spends outside any span
NO_SPAN = "harness, outside the program"


class HostSpans:
    """Labelled host intervals on ``time.perf_counter_ns``, each either
    inside another or apart from it."""

    def __init__(self) -> None:
        self.spans: List[Tuple[int, int, str]] = []

    def add(self, label: str, t0_ns: int, t1_ns: int) -> None:
        self.spans.append((t0_ns, t1_ns, label))

    def segments(self) -> List[Tuple[int, int, str]]:
        """The timeline cut into pieces, each labelled by the innermost
        span open over it (``NO_SPAN`` where none is), in order."""
        cuts = sorted({t for a, b, _ in self.spans for t in (a, b)})
        out: List[Tuple[int, int, str]] = []
        order = sorted(self.spans, key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[int, int, str]] = []
        i = 0
        for a, b in zip(cuts, cuts[1:]):
            while i < len(order) and order[i][0] <= a:
                stack.append(order[i])
                i += 1
            while stack and stack[-1][1] <= a:
                stack.pop()
            live = [s for s in stack if s[1] > a]
            out.append((a, b, live[-1][2] if live else NO_SPAN))
        return out


class _Labeller:
    """Labels of increasing times from a list of segments in one pass."""

    def __init__(self, segments: List[Tuple[int, int, str]]) -> None:
        self.seg, self.i = segments, 0

    def at(self, t: int) -> str:
        while self.i < len(self.seg) and self.seg[self.i][1] <= t:
            self.i += 1
        if self.i < len(self.seg) and self.seg[self.i][0] <= t:
            return self.seg[self.i][2]
        return NO_SPAN


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """``with DeviceTrace() as tr:`` around a window; then ``tr.ops``
    holds (name, start_ns, duration_ns) of each device operation in
    order, on the host clock (``perf_counter_ns``)."""

    def __init__(self) -> None:
        self.ops: List[Tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0

    def __enter__(self) -> "DeviceTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0_ns = time.perf_counter_ns()
        self._marker = torch.ones(1, device="cuda")   # first device op
        return self

    def __exit__(self, *exc) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        self._prof = None

    def _read(self) -> None:
        from torch.autograd import DeviceType
        dev = sorted((e.start_ns(), e.duration_ns(), e.name())
                     for e in self._prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA
                     and not e.is_user_annotation())
        if not dev:
            raise RuntimeError("the traced window holds no device operation")
        # the marker launched right after a synchronise is the first
        # device op: its start, less a launch latency, is self.t0_ns
        offset = dev[0][0] - self.t0_ns
        self.ops = [(n, s - offset, d) for s, d, n in dev]

    # ------------------------------------------------------------- readings
    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        return _merge([(s, s + d) for _, s, d in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            out[n] += d / 1e9
        return dict(out)

    def idle_by_span(self, spans: HostSpans) -> Dict[str, float]:
        """Seconds of every idle gap of the window, by the host span open at
        the gap's middle."""
        out: Dict[str, float] = defaultdict(float)
        labels = _Labeller(spans.segments())
        edge = self.t0_ns
        for a, b in self.busy_intervals() + [(self.t1_ns, self.t1_ns)]:
            if a > edge:
                out[labels.at((a + edge) // 2)] += (a - edge) / 1e9
            edge = max(edge, b)
        return dict(out)

    def breakdown(self, spans: HostSpans) -> Dict[str, list]:
        top = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_span(spans).items(),
                      key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in top[:10]],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def kernel_time(ops: Sequence[Tuple[str, int, int]],
                groups: Dict[str, Sequence[str]],
                follower: str = "combine_kernel") -> Dict[str, float]:
    """Device seconds of each group of kernels (a kernel is in a group
    when its name holds one of the group's words). A ``follower`` kernel
    (the split-KV combine that both attention kernels launch after
    themselves) goes to the group of the kernel that ran just before it."""
    out = {g: 0.0 for g in groups}
    last: Optional[str] = None
    for name, _, d in ops:
        if follower in name:
            if last is not None:
                out[last] += d / 1e9
            continue
        last = next((g for g, words in groups.items()
                     if any(w in name for w in words)), None)
        if last is not None:
            out[last] += d / 1e9
    return out
