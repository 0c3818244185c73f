"""Wall-clock spans and counters of the data plane.

One recorder per process, ``REC``. A span is a name, a start and an end on
``time.perf_counter_ns`` (the clock onto which a device trace of the same
process can map its operations), the index of the span that was open
around it (-1 at the top) and an optional id: a request's ``rid``, a step's
number, a layer's index. A counter is a named integer bumped at the same
sites; each bump is kept with its time, so that a reader can count it over
a window. The recorder keeps at most ``limit`` spans and ``limit`` bumps
and counts what it drops beyond them; nothing is written out: readers take
``REC.spans`` in the process.

It records only while a ``torch.profiler`` session is active or inside
``recording()``. The first ``on()`` that finds a profiler session active,
after one that found none, empties the recorder where no span and no
``recording()`` is open: a traced window that follows untraced steps is not
crowded out by an earlier profile's spans. A site tests ``on()`` in line
and does nothing else when it is false::

    sp = REC.open("engine.step", n) if on() else -1
    ...
    if sp >= 0:
        REC.close(sp)

A span left open by an exception keeps an end of 0 and is closed off the
stack by its parent's ``close``; readers skip it.

``syncs(src, dst)`` says whether a copy made the host wait on the device,
so that a site bumps ``host_syncs`` by what its copies did.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

_now = time.perf_counter_ns

__all__ = ["REC", "Recorder", "Span", "on", "recording", "syncs"]


class Span(NamedTuple):
    index: int
    name: str
    t0_ns: int
    t1_ns: int
    parent: int                 # index of the enclosing span, -1 at the top
    id: Optional[int]


class Recorder:
    """Spans and counter bumps of one process, in memory and bounded."""

    def __init__(self) -> None:
        self.limit = 1 << 20     # spans, and bumps, kept at most
        self.forced = 0          # open ``recording()`` contexts
        self.session = False     # a profiler session was on at the last test
        self.clear()

    def clear(self) -> None:
        #: [name, t0_ns, t1_ns, parent, id] of each span, in opening order
        self.rows: List[list] = []
        #: (t_ns, counter, n) of each bump, in order
        self.bumps: List[tuple] = []
        self.dropped = 0
        self._open: List[int] = [-1]     # open spans, innermost last

    def open(self, name: str, id: Optional[int] = None) -> int:
        """Start a span inside the innermost open one; its index, or -1 (a
        drop, counted) past the bound."""
        i = len(self.rows)
        if i >= self.limit:
            self.dropped += 1
            return -1
        self.rows.append([name, _now(), 0, self._open[-1], id])
        self._open.append(i)
        return i

    def close(self, i: int) -> None:
        """End span ``i`` (and take off the stack any span an exception left
        open inside it); -1, a dropped span's index, ends nothing."""
        t = _now()
        if i < 0:
            return
        self.rows[i][2] = t
        stack = self._open
        while len(stack) > 1 and stack.pop() != i:
            pass

    def count(self, name: str, n: int = 1) -> None:
        if len(self.bumps) >= self.limit:
            self.dropped += 1
            return
        self.bumps.append((_now(), name, n))

    # ------------------------------------------------------------ readings
    def spans(self, t0_ns: int = 0, t1_ns: Optional[int] = None
              ) -> List[Span]:
        """The closed spans that lie within [t0_ns, t1_ns], in opening
        order."""
        hi = t1_ns if t1_ns is not None else 1 << 63
        return [Span(i, *r) for i, r in enumerate(self.rows)
                if r[2] >= r[1] and t0_ns <= r[1] and r[2] <= hi]

    def counted(self, name: str, t0_ns: int = 0,
                t1_ns: Optional[int] = None) -> int:
        """Bumps of counter ``name`` within [t0_ns, t1_ns]."""
        hi = t1_ns if t1_ns is not None else 1 << 63
        return sum(n for t, c, n in self.bumps
                   if c == name and t0_ns <= t <= hi)


REC = Recorder()


def on() -> bool:
    """Whether sites record: a profiler session is active, or a
    ``recording()`` context is open. The first test in a profiler session
    after one outside any empties the recorder where nothing is open."""
    p = _profiler._is_profiler_enabled
    if p is not REC.session:
        REC.session = p
        if p and REC.forced == 0 and len(REC._open) == 1:
            REC.clear()
    return p or REC.forced > 0


def syncs(src: torch.Tensor, dst: torch.Tensor) -> int:
    """1 if the blocking copy (``.to()``, ``.cpu()``) of ``src`` into ``dst``
    made the host wait on the device, that is crossed between the host and
    a CUDA device (PyTorch ends such a copy with a synchronize); else 0."""
    a, b = src.device.type, dst.device.type
    return int(a != b and "cuda" in (a, b))


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record inside the block, with or without a profiler."""
    REC.forced += 1
    try:
        yield REC
    finally:
        REC.forced -= 1
