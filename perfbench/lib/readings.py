"""Readings that more than one metric takes, each from one section of a
run's record (``record["serve"]`` or ``record["decode"]``): the metric
files under ``metrics/`` pick the section."""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import counts
from .stats import percentile
from .trace import kernel_time


def _window_steps(s: Dict[str, Any]):
    return [c for c in s.get("step_calls", ())
            if s["t0_ns"] <= c[0] and c[1] <= s["end_ns"]]


def gap_percentile_ms(s: Optional[Dict[str, Any]], q: float):
    if not s or not s["gaps_s"]:
        return None
    return percentile(s["gaps_s"], q) * 1e3


def step_ms(s: Optional[Dict[str, Any]]):
    """Host ms a ``DecodeBatch.step`` over the window's steps."""
    calls = _window_steps(s or {"t0_ns": 0, "end_ns": 0})
    if not calls:
        return None
    return sum(b - a for a, b, _ in calls) / 1e6 / len(calls)


def decode_mfu(record: Dict[str, Any], s: Optional[Dict[str, Any]]):
    """The window's decode steps' operations (``counts.decode_flops`` of
    the active sequences' keys) over the host time in the steps at the
    bf16 peak, in %."""
    calls = _window_steps(s or {"t0_ns": 0, "end_ns": 0})
    if not calls:
        return None
    flops = sum(counts.decode_flops(record["cfg"], keys)
                for _, _, keys in calls)
    secs = sum(b - a for a, b, _ in calls) / 1e9
    return 100.0 * flops / (secs * counts.PEAK_FLOPS_BF16)


def decode_roofline(record: Dict[str, Any], s: Optional[Dict[str, Any]]):
    """The decode attention kernel's share of its roofline over the traced
    window: each call's bound (``counts.decode_attn_work`` of the active
    sequences' keys, every layer of every step) over the device time of
    ``decode_kernel`` and the combines it launched, in %."""
    tr = record.get("trace")
    if not s or tr is None:
        return None
    cfg = record["cfg"]
    works = [counts.decode_attn_work(cfg, keys)
             for a, b, keys in s["step_calls"]
             if tr.t0_ns <= a and b <= tr.t1_ns and keys]
    works = works * cfg["num_hidden_layers"]
    secs = kernel_time(tr.ops, counts.KERNELS)["decode_attention"]
    got = counts.roofline_pct(works, secs)
    return None if got is None else got[0]


def idle_pct(record: Dict[str, Any], kind: str):
    tr = record.get("trace")
    if tr is None or kind not in record or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
