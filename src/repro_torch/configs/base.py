"""ArchConfig — the single source of truth for every architecture.

Consumed by three layers:
  * repro.models      — builds the JAX module graph from it;
  * repro.simcluster  — derives FLOPs / KV-bytes / collective volumes for the
                        event-driven serving simulation (Vidur-style analytic
                        latency model);
  * repro.launch      — input_specs + sharding for the multi-pod dry-run.

Analytic accounting conventions:
  * params are real parameter counts (embeddings included once when tied);
  * flops_per_token counts the standard 2*params_active matmul FLOPs plus the
    attention score/value term for the given context length;
  * kv_bytes_per_token_layer is the per-layer per-token KV-cache footprint —
    the quantity Stage-1/Stage-3 flows carry. MLA stores the compressed
    latent (kv_lora_rank + rope head) instead of full K/V; SSM/hybrid layers
    store O(1) state instead of per-token KV.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeCell", "SHAPES"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0              # shared (always-on) experts
    d_expert: int = 0              # per-expert FFN width (fine-grained MoE)
    first_dense: int = 0           # leading dense layers (DeepSeek style)

    # --- MLA (DeepSeek-V3) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window: int = 0                        # local-attention window
    rglru_width: int = 0                   # recurrent block width (lru_width)

    # --- encoder-decoder (Seamless-M4T) ---
    enc_layers: int = 0

    # --- misc ---
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    mtp: bool = False              # multi-token prediction head (DSv3)
    source: str = ""

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, layer: int) -> str:
        """'attn' | 'rec' | 'ssm' — the sequence-mixing kind of a layer."""
        if self.family == "ssm":
            return "ssm"
        if self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        return "attn"

    def n_attn_layers(self) -> int:
        return sum(1 for l in range(self.n_layers) if self.layer_kind(l) == "attn")

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and layer >= self.first_dense

    # ------------------------------------------------------ param accounting
    def attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.use_mla:
            # q: d->q_lora->heads*(nope+rope); kv: d->kv_lora(+rope); o.
            qr = self.q_lora_rank or self.d_model
            p = d * qr + qr * self.n_heads * (self.nope_head_dim + self.rope_head_dim)
            p += d * (self.kv_lora_rank + self.rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def rec_params(self) -> int:
        # Griffin recurrent block: in-proj d->2w (branch + gate), temporal
        # conv, block-diagonal RG-LRU input/recurrence gates, out-proj w->d.
        w = self.rglru_width or self.d_model
        gates = 2 * w * max(1, w // 16)   # block-diagonal gate matrices
        return 2 * self.d_model * w + self.ssm_conv * w + gates + w * self.d_model

    def ssm_params(self) -> int:
        d_in = self.ssm_expand * self.d_model
        # Mamba2: in_proj (z,x,B,C,dt) + out_proj + conv
        n_g = 1
        proj = self.d_model * (2 * d_in + 2 * n_g * self.ssm_state + d_in // self.ssm_head_dim)
        return proj + d_in * self.d_model + self.ssm_conv * (d_in + 2 * self.ssm_state)

    def ffn_params_dense(self) -> int:
        return 3 * self.d_model * self.d_ff       # SwiGLU

    def ffn_params_expert(self) -> int:
        return 3 * self.d_model * self.d_expert

    def moe_layer_params(self) -> int:
        p = (self.n_experts + self.n_shared) * self.ffn_params_expert()
        p += self.d_model * self.n_experts        # router
        return p

    def params(self) -> int:
        """Total parameters (approximate, embedding included once if tied)."""
        p = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        layers = self.n_layers + self.enc_layers
        for l in range(self.n_layers):
            kind = self.layer_kind(l)
            if kind == "attn":
                p += self.attn_params()
            elif kind == "rec":
                p += self.rec_params()
            else:
                p += self.ssm_params()
            if self.family == "ssm":
                continue                           # mamba2 has no separate FFN
            if self.is_moe_layer(l):
                p += self.moe_layer_params()
            else:
                p += self.ffn_params_dense()
            if self.enc_layers and l < self.enc_layers:
                p += self.attn_params()            # decoder cross-attention
        for _ in range(self.enc_layers):           # encoder stack
            p += self.attn_params() + self.ffn_params_dense()
        p += 2 * self.d_model * layers             # norms
        return p

    def params_active(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.params()
        p = self.params()
        moe_layers = sum(1 for l in range(self.n_layers) if self.is_moe_layer(l))
        inactive = (self.n_experts - self.top_k) * self.ffn_params_expert()
        return p - moe_layers * inactive

    # ------------------------------------------------------ flops accounting
    def flops_per_token(self, ctx: int = 0) -> float:
        """Forward FLOPs per token: 2*active-params + attention scores.

        ``ctx`` is the average attended context length (0 = ignore the
        quadratic term). Local-attention layers cap ctx at the window; rec /
        ssm layers have linear state updates already counted in params.
        """
        f = 2.0 * self.params_active()
        if ctx > 0:
            for l in range(self.n_layers):
                kind = self.layer_kind(l)
                if kind == "attn":
                    eff = min(ctx, self.window) if self.window else ctx
                    dim = (self.n_heads * (self.nope_head_dim + self.rope_head_dim)
                           if self.use_mla else self.n_heads * self.hd)
                    f += 4.0 * eff * dim          # QK^T + AV
        return f

    # ------------------------------------------------------ KV accounting
    def kv_bytes_per_token_layer(self, dtype_bytes: int = 2, layer: int = 0) -> float:
        kind = self.layer_kind(layer)
        if kind == "ssm":
            return 0.0                             # state is O(1), see state_bytes
        if kind == "rec":
            return 0.0
        if self.use_mla:
            return (self.kv_lora_rank + self.rope_head_dim) * dtype_bytes
        return 2.0 * self.n_kv * self.hd * dtype_bytes

    def kv_bytes_per_token(self, dtype_bytes: int = 2, window_cap: int = 0) -> float:
        """Per-token KV bytes summed over layers (local-attn layers included;
        the *cache* for them is capped at the window — handled by caller)."""
        return sum(self.kv_bytes_per_token_layer(dtype_bytes, l)
                   for l in range(self.n_layers))

    def state_bytes(self, dtype_bytes: int = 2) -> float:
        """Fixed-size recurrent state per sequence (SSM / RG-LRU layers)."""
        total = 0.0
        for l in range(self.n_layers):
            kind = self.layer_kind(l)
            if kind == "ssm":
                d_in = self.ssm_expand * self.d_model
                heads = d_in // self.ssm_head_dim
                total += heads * self.ssm_head_dim * self.ssm_state * dtype_bytes
                total += self.ssm_conv * d_in * dtype_bytes
            elif kind == "rec":
                total += (self.rglru_width or self.d_model) * dtype_bytes
        return total


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
    needs_subquadratic: bool = False


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode", needs_subquadratic=True),
)
