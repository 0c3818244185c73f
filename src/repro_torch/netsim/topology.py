"""Network topologies for the flow-level simulator.

Node ids are flat integers, one per NIC-attached endpoint (GPU/NIC pair) —
the paper's testbed exposes 2×100G NICs per 4-GPU server and the simulation
8 NICs per 8-GPU server, so "one endpoint per GPU share of NIC bandwidth" is
the natural granularity.

Topologies provide:
    route(src, dst, fid) -> tuple[int, ...]   link ids traversed
    capacity[lid]                              bytes/sec

Intra-server traffic rides the scale-up fabric (NVSwitch / ICI), modelled as
per-endpoint scale-up up/down links so it can still contend when many
neighbours target one victim endpoint — matching §2.2's victim-unit NIC
contention story at the server boundary.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["Topology", "SingleToR", "FatTree"]

GB = 1e9
Gb = 1e9 / 8


@dataclass
class Topology:
    n_nodes: int
    capacity: Dict[int, float] = field(default_factory=dict)

    def route(self, src: int, dst: int, fid: int = 0) -> Tuple[int, ...]:
        raise NotImplementedError

    def server_of(self, node: int) -> int:
        raise NotImplementedError


class SingleToR(Topology):
    """All endpoints under one Top-of-Rack switch (the paper's testbed).

    Links (per endpoint i): 2i = uplink (host->ToR), 2i+1 = downlink. The ToR
    backplane is non-blocking. Endpoints on the same server communicate over
    the scale-up fabric: links 2N+2j / 2N+2j+1 are server-local egress/ingress
    with ``scaleup_bw``.
    """

    def __init__(self, n_nodes: int, nic_bw: float = 100 * Gb,
                 gpus_per_server: int = 4, scaleup_bw: float = 900 * GB):
        super().__init__(n_nodes)
        self.gpus_per_server = gpus_per_server
        for i in range(n_nodes):
            self.capacity[2 * i] = nic_bw
            self.capacity[2 * i + 1] = nic_bw
        base = 2 * n_nodes
        self._su = base
        for i in range(n_nodes):
            self.capacity[base + 2 * i] = scaleup_bw
            self.capacity[base + 2 * i + 1] = scaleup_bw

    def server_of(self, node: int) -> int:
        return node // self.gpus_per_server

    def route(self, src: int, dst: int, fid: int = 0) -> Tuple[int, ...]:
        if src == dst:
            return ()
        if self.server_of(src) == self.server_of(dst):
            return (self._su + 2 * src, self._su + 2 * dst + 1)
        return (2 * src, 2 * dst + 1)


class FatTree(Topology):
    """Two-tier leaf-spine with 1:1 oversubscription and per-flow ECMP.

    ``racks`` leaves, ``hosts_per_rack`` endpoints each, ``n_spines`` spines.
    Link naming:
        host up / down:            2i, 2i+1
        leaf(r) -> spine(s) up:    U(r, s)
        spine(s) -> leaf(r) down:  D(r, s)
        scale-up egress/ingress:   per endpoint, as in SingleToR
    ECMP picks the spine by hashing the flow id, a per-flow static choice as
    in real fabrics (hash collisions are part of the contention the paper
    studies).
    """

    def __init__(self, racks: int, hosts_per_rack: int,
                 nic_bw: float = 200 * Gb, n_spines: int | None = None,
                 gpus_per_server: int = 8, scaleup_bw: float = 900 * GB):
        super().__init__(racks * hosts_per_rack)
        self.racks = racks
        self.hosts_per_rack = hosts_per_rack
        self.gpus_per_server = gpus_per_server
        # 1:1 fat tree: aggregate spine bandwidth == aggregate host bandwidth
        self.n_spines = n_spines or hosts_per_rack
        spine_bw = nic_bw * hosts_per_rack / self.n_spines
        n = self.n_nodes
        for i in range(n):
            self.capacity[2 * i] = nic_bw
            self.capacity[2 * i + 1] = nic_bw
        self._up0 = 2 * n
        self._dn0 = 2 * n + racks * self.n_spines
        for r in range(racks):
            for s in range(self.n_spines):
                self.capacity[self._up0 + r * self.n_spines + s] = spine_bw
                self.capacity[self._dn0 + r * self.n_spines + s] = spine_bw
        self._su = self._dn0 + racks * self.n_spines
        for i in range(n):
            self.capacity[self._su + 2 * i] = scaleup_bw
            self.capacity[self._su + 2 * i + 1] = scaleup_bw

    def rack_of(self, node: int) -> int:
        return node // self.hosts_per_rack

    def server_of(self, node: int) -> int:
        return node // self.gpus_per_server

    def route(self, src: int, dst: int, fid: int = 0) -> Tuple[int, ...]:
        if src == dst:
            return ()
        if self.server_of(src) == self.server_of(dst):
            return (self._su + 2 * src, self._su + 2 * dst + 1)
        rs, rd = self.rack_of(src), self.rack_of(dst)
        if rs == rd:
            return (2 * src, 2 * dst + 1)
        s = (fid * 2654435761) % self.n_spines        # deterministic ECMP hash
        return (2 * src,
                self._up0 + rs * self.n_spines + s,
                self._dn0 + rd * self.n_spines + s,
                2 * dst + 1)
