"""Operations, bytes, roofline bounds and the published peaks, frozen.

Every count is worked out from a configuration's widths (its file under
``configs/``) and the shapes the traffic gave: each call's lengths, heads
and head dim. A kernel's bytes count each input byte read once and each
output byte written once. A model's operations count the products of its
matrices (2 a multiply-add) and of attention (QK^T and PV, 4 * head dim a
query head and key), over the real heads of the configuration: a head the
program pads on is no work the model needs.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

#: NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of the same part
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
F32 = 4


def dims(cfg: Dict[str, Any]) -> Tuple[int, ...]:
    """(layers, d_model, heads, kv heads, head dim, d_ff, vocab)."""
    return (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"])


def layer_matrix_params(cfg: Dict[str, Any]) -> int:
    """Weights of one layer's products: q, k, v, o and the gated MLP's
    three matrices."""
    _, d, H, Hkv, hd, ff, _ = dims(cfg)
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * ff


def params(cfg: Dict[str, Any]) -> int:
    """Every parameter: the embedding, the layers (norm gains included),
    the final norm and the unembedding."""
    L, d, *_, V = dims(cfg)
    return 2 * V * d + L * (layer_matrix_params(cfg) + 2 * d) + d


def causal_pairs(T: int, offset: int = 0) -> int:
    """(query, key) pairs of ``T`` queries at positions ``offset ..
    offset + T - 1`` under a causal mask."""
    return T * offset + T * (T + 1) // 2


def _attn_flops_per_pair(cfg: Dict[str, Any]) -> int:
    _, _, H, _, hd, _, _ = dims(cfg)
    return 4 * H * hd


def prefill_flops(cfg: Dict[str, Any], T: int, prefix: int = 0) -> float:
    """A prefill of ``T`` new tokens after ``prefix`` cached ones: every
    layer's products for the new tokens, their causal attention, and the
    logits of the last position (all a prefill returns)."""
    L, d, *_, V = dims(cfg)
    return float(L * (2 * layer_matrix_params(cfg) * T
                      + _attn_flops_per_pair(cfg) * causal_pairs(T, prefix))
                 + 2 * d * V)


def decode_flops(cfg: Dict[str, Any], keys: Iterable[int]) -> float:
    """One decode step of the sequences that attend over ``keys`` keys
    each (their own new key included): products, attention, logits."""
    L, d, *_, V = dims(cfg)
    keys = list(keys)
    return float(len(keys) * (L * 2 * layer_matrix_params(cfg) + 2 * d * V)
                 + L * _attn_flops_per_pair(cfg) * sum(keys))


def train_flops(cfg: Dict[str, Any], B: int, T: int) -> float:
    """One training step on B x T tokens: the forward (products, causal
    attention, the logits of every position) and a backward of twice its
    operations."""
    L, d, *_, V = dims(cfg)
    fwd = (L * (2 * layer_matrix_params(cfg) * B * T
                + _attn_flops_per_pair(cfg) * B * causal_pairs(T))
           + 2 * d * V * B * T)
    return 3.0 * fwd


def flash_fwd_work(cfg: Dict[str, Any], B: int, T: int, offset: int
                   ) -> Tuple[float, float]:
    """(operations, bytes) of one causal prefill attention call: T queries
    after ``offset`` cached keys, over T + offset keys; q, k, v read once
    and the output written once, bf16."""
    _, _, H, Hkv, hd, _, _ = dims(cfg)
    S = T + offset
    flops = _attn_flops_per_pair(cfg) * B * causal_pairs(T, offset)
    nbytes = BF16 * (2 * B * T * H * hd + 2 * B * S * Hkv * hd)
    return float(flops), float(nbytes)


def decode_attn_work(cfg: Dict[str, Any], keys: Iterable[int]
                     ) -> Tuple[float, float]:
    """(operations, bytes) of one decode attention call over sequences of
    ``keys`` keys each: every key and value of every KV head read once,
    the query and the output of every head once, bf16."""
    _, _, H, Hkv, hd, _, _ = dims(cfg)
    keys = list(keys)
    flops = _attn_flops_per_pair(cfg) * sum(keys)
    nbytes = BF16 * (2 * Hkv * hd * sum(keys) + 2 * len(keys) * H * hd)
    return float(flops), float(nbytes)


def flash_bwd_work(cfg: Dict[str, Any], B: int, T: int
                   ) -> Tuple[float, float]:
    """(operations, bytes) of one causal attention backward over B x T:
    five products a pair (the scores again, dP, dQ, dK, dV) against the
    forward's two, so 2.5 x its operations; q, k, v, the output, its
    gradient (bf16) and the row lse (float32) read, dq, dk, dv written."""
    _, _, H, Hkv, hd, _, _ = dims(cfg)
    f, _ = flash_fwd_work(cfg, B, T, 0)
    nbytes = (BF16 * (3 * B * T * H * hd + 2 * B * T * Hkv * hd)
              + F32 * B * H * T
              + BF16 * (B * T * H * hd + 2 * B * T * Hkv * hd))
    return 2.5 * f, float(nbytes)


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the chip could take, and which term sets it."""
    t_f, t_b = flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S
    return (t_f, "operations") if t_f >= t_b else (t_b, "bytes")


#: the program's attention kernels by the words their device names hold
#: (``csrc/*.cu``); the split-KV ``combine_kernel`` each launches after
#: itself counts with it (``trace.kernel_time``)
KERNELS = {
    "flash_attention": ("flash_mma_kernel", "flash_f32_kernel"),
    "decode_attention": ("decode_kernel",),
    "flash_attention_bwd": ("dkdv_wgmma_kernel", "dq_wgmma_kernel",
                            "delta_kernel", "sum_splits_kernel",
                            "dkdv_f32_kernel", "dq_f32_kernel"),
}


def roofline_pct(works: Iterable[Tuple[float, float]], seconds: float):
    """(share of the roofline in %, the term that bounds most of the
    calls) of calls of (operations, bytes) that took ``seconds`` on the
    device in all; None where they took no time."""
    total, terms = 0.0, {"operations": 0.0, "bytes": 0.0}
    for f, b in works:
        t, term = bound_s(f, b)
        total += t
        terms[term] += t
    if seconds <= 0 or total <= 0:
        return None
    return 100.0 * total / seconds, max(terms, key=terms.get)
