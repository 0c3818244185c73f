"""Serving metrics — TTFT, SLO attainment, CCT, earliness (§6.1), plus the
decode plane's TPOT/TBT attainment per pool and per SLO class.

With admission control active (router plane), attainment is reported two
ways: ``slo_attainment`` counts every arrival (a shed request is a miss —
rejecting hard requests cannot inflate it) while ``admitted_attainment``
covers served requests only; both exist overall and per SLO class.

SLO definition follows the paper: threshold = ``slo_scale`` (default 3x) times
the TTFT measured under low-load (contention-free) conditions for the same
request — computed analytically per request by the simulator's ideal path.
Decode TPOT attainment compares each request's mean time-per-output-token
(== mean TBT after the first token) against its pool's per-class budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["CoflowRecord", "SimMetrics"]


@dataclass
class CoflowRecord:
    cid: int
    unit: int
    layer: int
    started: float
    finished: float
    size: float
    ideal: float            # serialised transfer time at full line rate

    @property
    def cct(self) -> float:
        return self.finished - self.started

    @property
    def slowdown(self) -> float:
        return self.cct / max(self.ideal, 1e-12)


@dataclass
class SimMetrics:
    policy: str = ""
    ttft: Dict[int, float] = field(default_factory=dict)
    deadline: Dict[int, float] = field(default_factory=dict)
    arrival: Dict[int, float] = field(default_factory=dict)
    ideal_ttft: Dict[int, float] = field(default_factory=dict)
    stall_time: Dict[int, float] = field(default_factory=dict)
    prompt_tokens: Dict[int, int] = field(default_factory=dict)
    coflows: List[CoflowRecord] = field(default_factory=list)
    pruned: int = 0
    # --- decode plane (empty when no DecodePlane is attached) ---
    slo_class: Dict[int, str] = field(default_factory=dict)
    pool_of: Dict[int, str] = field(default_factory=dict)
    tpot: Dict[int, float] = field(default_factory=dict)      # mean TBT
    tbt_max: Dict[int, float] = field(default_factory=dict)   # worst gap
    tpot_budget: Dict[int, float] = field(default_factory=dict)
    decode_stats: Dict[str, float] = field(default_factory=dict)
    # --- KV-reuse plane (empty when no KVStore is attached) ---
    kv_hit_tokens: Dict[int, int] = field(default_factory=dict)
    kv_prompt_tokens: Dict[int, int] = field(default_factory=dict)
    kv_tier_tokens: Dict[str, int] = field(default_factory=dict)
    kvstore_stats: Dict[str, float] = field(default_factory=dict)
    # --- router/admission plane (empty when admission control is off) ---
    shed: Dict[int, str] = field(default_factory=dict)   # rid -> slo_class
    n_deferred: int = 0                                  # defer retries total
    # rows the bounded stage log dropped on overflow (0 = trace complete;
    # nonzero means parity/attribution over the log would be partial)
    stage_log_dropped: int = 0

    # ------------------------------------------------------------- summaries
    def _rids(self):
        return [r for r in self.ttft if r >= 0]      # exclude warm-up

    def _shed_rids(self, slo_class: Optional[str] = None):
        return [r for r, c in self.shed.items()
                if r >= 0 and (slo_class is None or c == slo_class)]

    def slo_attainment(self) -> float:
        """All-arrivals TTFT attainment: a shed request never got a first
        token, so it counts as a miss in the denominator — admission
        control cannot inflate this number by rejecting hard requests."""
        rids = self._rids()
        n_shed = len(self._shed_rids())
        if not rids and not n_shed:
            return float("nan")
        ok = sum(1 for r in rids if self.ttft[r] <= self.deadline[r] + 1e-9)
        return ok / (len(rids) + n_shed)

    def admitted_attainment(self) -> float:
        """TTFT attainment over admitted (served) requests only — what the
        accepted traffic experienced. With admission off this equals
        :meth:`slo_attainment`."""
        rids = self._rids()
        if not rids:
            return float("nan")
        ok = sum(1 for r in rids if self.ttft[r] <= self.deadline[r] + 1e-9)
        return ok / len(rids)

    def ttft_stats(self):
        v = np.array([self.ttft[r] for r in self._rids()])
        if v.size == 0:
            return {}
        return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
                "p90": float(np.percentile(v, 90)), "p99": float(np.percentile(v, 99))}

    def long_prompt_stats(self, min_tokens: int) -> Dict[str, float]:
        """Mean TTFT + SLO attainment of the long-prompt class (prompts of
        at least ``min_tokens``) — the head-of-line-blocking victims chunked
        prefill exists to help."""
        rids = [r for r in self._rids()
                if self.prompt_tokens.get(r, 0) >= min_tokens]
        if not rids:
            return {"n": 0, "ttft_mean": float("nan"),
                    "ttft_p99": float("nan"), "attainment": float("nan")}
        v = np.array([self.ttft[r] for r in rids])
        ok = sum(1 for r in rids if self.ttft[r] <= self.deadline[r] + 1e-9)
        return {"n": len(rids), "ttft_mean": float(v.mean()),
                "ttft_p99": float(np.percentile(v, 99)),
                "attainment": ok / len(rids)}

    def normalized_ttft(self) -> float:
        """Mean TTFT / mean ideal TTFT (contention inflation factor)."""
        rids = self._rids()
        if not rids:
            return float("nan")
        num = np.mean([self.ttft[r] for r in rids])
        den = np.mean([self.ideal_ttft[r] for r in rids])
        return float(num / max(den, 1e-12))

    def mean_cct(self) -> float:
        if not self.coflows:
            return float("nan")
        return float(np.mean([c.cct for c in self.coflows]))

    def cct_slowdown(self) -> float:
        if not self.coflows:
            return float("nan")
        return float(np.mean([c.slowdown for c in self.coflows]))

    def earliness(self) -> np.ndarray:
        """deadline - TTFT per request; positive = early, negative = miss."""
        rids = self._rids()
        return np.array([self.deadline[r] - self.ttft[r] for r in rids])

    def positive_earliness(self) -> float:
        e = self.earliness()
        pos = e[e > 0]
        return float(pos.mean()) if pos.size else 0.0

    # --------------------------------------------------------- decode plane
    def _tpot_rids(self, pool: Optional[str] = None,
                   slo_class: Optional[str] = None) -> List[int]:
        return [r for r in self.tpot
                if r >= 0
                and (pool is None or self.pool_of.get(r) == pool)
                and (slo_class is None or self.slo_class.get(r) == slo_class)]

    def tpot_attainment(self, pool: Optional[str] = None,
                        slo_class: Optional[str] = None) -> float:
        """Fraction of decoded requests whose mean TBT met their budget."""
        rids = self._tpot_rids(pool, slo_class)
        if not rids:
            return float("nan")
        ok = sum(1 for r in rids
                 if self.tpot[r] <= self.tpot_budget.get(r, np.inf) + 1e-12)
        return ok / len(rids)

    def tpot_attainment_by_pool(self) -> Dict[str, float]:
        pools = sorted({self.pool_of[r] for r in self._tpot_rids()})
        return {p: self.tpot_attainment(pool=p) for p in pools}

    def tpot_attainment_by_class(self) -> Dict[str, float]:
        classes = sorted({self.slo_class.get(r, "standard")
                          for r in self._tpot_rids()})
        return {c: self.tpot_attainment(slo_class=c) for c in classes}

    def slo_attainment_by_class(self) -> Dict[str, float]:
        """All-arrivals attainment per SLO class (shed counts as a miss
        against its class)."""
        by: Dict[str, List[int]] = {}
        for r in self._rids():
            by.setdefault(self.slo_class.get(r, "standard"), []).append(r)
        shed_by: Dict[str, int] = {}
        for r in self._shed_rids():
            shed_by[self.shed[r]] = shed_by.get(self.shed[r], 0) + 1
        classes = sorted(set(by) | set(shed_by))
        return {c: sum(1 for r in by.get(c, ())
                       if self.ttft[r] <= self.deadline[r] + 1e-9)
                / (len(by.get(c, ())) + shed_by.get(c, 0))
                for c in classes}

    def admitted_attainment_by_class(self) -> Dict[str, float]:
        """Admitted-only attainment per SLO class."""
        by: Dict[str, List[int]] = {}
        for r in self._rids():
            by.setdefault(self.slo_class.get(r, "standard"), []).append(r)
        return {c: sum(1 for r in rids
                       if self.ttft[r] <= self.deadline[r] + 1e-9) / len(rids)
                for c, rids in sorted(by.items())}

    def tpot_stats(self) -> Dict[str, float]:
        v = np.array([self.tpot[r] for r in self._tpot_rids()])
        if v.size == 0:
            return {}
        return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
                "p99": float(np.percentile(v, 99)),
                "tbt_max": float(max((g for r, g in self.tbt_max.items()
                                      if r >= 0), default=0.0))}

    # ------------------------------------------------------- KV-reuse plane
    def kv_hit_rate(self) -> float:
        """Reused tokens / prompt tokens over measured (non-warmup)
        requests — the live-store hit rate the sweeps report."""
        tot = sum(self.kv_prompt_tokens.values())
        if not tot:
            return float("nan")
        return sum(self.kv_hit_tokens.values()) / tot

    def kv_tier_mix(self) -> Dict[str, float]:
        """Share of hit tokens served per storage tier."""
        tot = sum(self.kv_tier_tokens.values())
        if not tot:
            return {}
        return {t: v / tot for t, v in sorted(self.kv_tier_tokens.items())}

    def summary(self) -> Dict[str, float]:
        s = {"policy": self.policy, "n": len(self._rids()),
             "slo_attainment": self.slo_attainment(),
             "norm_ttft": self.normalized_ttft(),
             "cct_slowdown": self.cct_slowdown(),
             "pos_earliness": self.positive_earliness(),
             "pruned": self.pruned}
        s.update({f"ttft_{k}": v for k, v in self.ttft_stats().items()})
        if self.tpot:            # decode plane attached: report TPOT side
            s["tpot_attainment"] = self.tpot_attainment()
            s["tpot_by_pool"] = self.tpot_attainment_by_pool()
            s.update({f"tpot_{k}": v for k, v in self.tpot_stats().items()})
            s.update({f"decode_{k}": v for k, v in self.decode_stats.items()})
        if self.kv_prompt_tokens:   # KV-reuse plane attached
            s["kv_hit_rate"] = self.kv_hit_rate()
            s["kv_tier_mix"] = self.kv_tier_mix()
            s.update({f"kv_{k}": v for k, v in self.kvstore_stats.items()})
        if self.shed or self.n_deferred:   # admission control acted
            s["n_shed"] = len(self._shed_rids())
            s["n_deferred"] = self.n_deferred
            s["admitted_attainment"] = self.admitted_attainment()
            s["attainment_by_class"] = self.slo_attainment_by_class()
            s["admitted_by_class"] = self.admitted_attainment_by_class()
        if self.stage_log_dropped:   # bounded stage trace overflowed
            s["stage_log_dropped"] = self.stage_log_dropped
        return s
