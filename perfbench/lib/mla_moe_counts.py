"""Operations, bytes and readings of an MLA and expert decode step
(DeepSeek-V3's configuration files), at the published peaks of
``counts.py``.

Counts come from the configuration's widths and the window's shapes: each
step's live keys (a sequence's cached positions and its new one) and the
pairs routed to each held expert of each expert layer, which the program's
counter ``moe_held_pairs`` gives, one bump a (step, layer, held expert).
Operations count the products (2 a multiply-add) the decoded tokens need:
none for a held expert no token chose, none for the positions past a
sequence's length.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from .counts import BF16, PEAK_FLOPS_BF16, roofline_pct


def latent_bytes(cfg: Dict[str, Any]) -> int:
    """A cached position's latent and rope key, bf16: 1152 B."""
    return BF16 * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])


def mla_pair_flops(cfg: Dict[str, Any]) -> int:
    """Absorbed attention a (query, key) pair, every head: the scores over
    the latent and the rope key, and the latent's weighted sum."""
    r, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    return 2 * cfg["num_attention_heads"] * ((r + dr) + r)


def mla_attend_work(cfg: Dict[str, Any], keys: Iterable[int]):
    """(operations, bytes) of one layer's attention core over sequences of
    ``keys`` live keys each: each key's latent and rope key read once."""
    n = sum(keys)
    return float(mla_pair_flops(cfg) * n), float(latent_bytes(cfg) * n)


def expert_bytes(cfg: Dict[str, Any]) -> int:
    """One routed expert's three matrices, bf16."""
    return BF16 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def expert_pair_flops(cfg: Dict[str, Any]) -> int:
    return 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def moe_experts_work(cfg: Dict[str, Any], pairs: int):
    """(operations, bytes) of one held expert of one layer that ``pairs``
    (token, expert) pairs reached in a step: its weights read once where
    any did, each pair's row read in and written out."""
    row = BF16 * cfg["hidden_size"]
    return (float(expert_pair_flops(cfg) * pairs),
            float((expert_bytes(cfg) if pairs else 0) + 2 * row * pairs))


def token_flops(cfg: Dict[str, Any]) -> int:
    """A decoded token's products outside attention's pairs and the routed
    experts: MLA's projections (the query's bottleneck, the latent and
    rope key, the absorbed ``W_kb`` and ``W_vb``, the output), the dense
    layers' MLPs, the expert layers' routers and shared experts, and the
    head."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, qr = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    L, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    mla = d * qr + qr * H * (dn + dr) + d * (r + dr) + H * dn * r \
        + H * r * dv + H * dv * d
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["published"]["n_routed_experts"] \
        + 3 * d * cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    return 2 * (L * mla + k * dense + (L - k) * moe + d * V)


def decode_flops(cfg: Dict[str, Any], keys: Iterable[int],
                 pairs: int) -> float:
    """One decode step of the sequences with ``keys`` live keys each, whose
    tokens sent ``pairs`` (token, expert) pairs to the held experts over
    every expert layer."""
    keys = list(keys)
    return float(len(keys) * token_flops(cfg)
                 + cfg["num_hidden_layers"] * mla_pair_flops(cfg) * sum(keys)
                 + expert_pair_flops(cfg) * pairs)


# ------------------------------------------------------------- readings
def _window(record: Dict[str, Any]):
    """(the program's decode window, the recorder) or None: no trace, a
    program without the recorder, or no step in the window."""
    from .spans import decode_window
    w = decode_window(record)
    if w is None:
        return None
    from repro_torch.tracing import REC
    return w, REC


def section_ms(record: Dict[str, Any], name: str) -> Optional[List[float]]:
    """The device ms of section ``name`` filed in the traced window, or
    None where the program files none."""
    got = _window(record)
    if got is None or not hasattr(got[1], "section_ms"):
        return None
    tr = record["trace"]
    ms = got[1].section_ms(name, tr.t0_ns, tr.t1_ns)
    return ms or None


def per_step_ms(record: Dict[str, Any], name: str) -> Optional[float]:
    ms = section_ms(record, name)
    if ms is None:
        return None
    return sum(ms) / len(_window(record)[0].steps)


def held_pairs(record: Dict[str, Any]) -> Optional[List[int]]:
    """The counter ``moe_held_pairs``'s bumps in the traced window, one a
    (step, expert layer, held expert), or None where there are none."""
    got = _window(record)
    if got is None:
        return None
    tr = record["trace"]
    n = [b[2] for b in got[1].bumps
         if b[1] == "moe_held_pairs" and tr.t0_ns <= b[0] <= tr.t1_ns]
    return n or None


def window_keys(record: Dict[str, Any]) -> List[List[int]]:
    """The live keys of each decode step inside the traced window."""
    tr, s = record["trace"], record["decode"]
    return [keys for a, b, keys in s["step_calls"]
            if tr.t0_ns <= a and b <= tr.t1_ns]


def mla_roofline(record: Dict[str, Any]) -> Optional[float]:
    """The MLA cores' bound at the live lengths over their device time
    (section ``mla.attend``), in %."""
    ms = section_ms(record, "mla.attend")
    if ms is None:
        return None
    cfg = record["cfg"]
    works = [mla_attend_work(cfg, keys) for keys in window_keys(record)]
    got = roofline_pct(works * cfg["num_hidden_layers"], sum(ms) / 1e3)
    return None if got is None else got[0]


def experts_roofline(record: Dict[str, Any]) -> Optional[float]:
    """The held experts' bound (each expert some pair reached read once,
    the pairs' rows in and out) over their device time (section
    ``moe.experts``), in %."""
    ms, pairs = section_ms(record, "moe.experts"), held_pairs(record)
    if ms is None or pairs is None:
        return None
    works = [moe_experts_work(record["cfg"], n) for n in pairs]
    got = roofline_pct(works, sum(ms) / 1e3)
    return None if got is None else got[0]


def pairs_per_step(record: Dict[str, Any]) -> Optional[float]:
    """The pairs the held experts of every expert layer got a step."""
    pairs = held_pairs(record)
    if pairs is None:
        return None
    return sum(pairs) / len(_window(record)[0].steps)


def mfu(record: Dict[str, Any]) -> Optional[float]:
    """The traced window's decode steps' operations (``decode_flops``, the
    routed pairs from ``moe_held_pairs``) over the host time in the steps
    at the bf16 peak, in %."""
    pairs = held_pairs(record)
    if pairs is None:
        return None
    tr, s = record["trace"], record["decode"]
    calls = [c for c in s["step_calls"] if tr.t0_ns <= c[0]
             and c[1] <= tr.t1_ns]
    if not calls:
        return None
    cfg = record["cfg"]
    flops = sum(decode_flops(cfg, keys, 0) for _, _, keys in calls) \
        + expert_pair_flops(cfg) * sum(pairs)
    secs = sum(b - a for a, b, _ in calls) / 1e9
    return 100.0 * flops / (secs * PEAK_FLOPS_BF16)

