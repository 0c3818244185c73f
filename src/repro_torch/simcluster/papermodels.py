"""The paper's evaluation models (§6.2/§6.3) as ArchConfigs.

All hyperparameters come from public model cards / tech reports:
  * Mixtral-8x7B / 8x22B  — mistralai HF cards
  * DBRX                  — databricks blog (16 experts, top-4)
  * Grok                  — xai-org/grok-1 open release (Grok-2 internals are
                            unpublished; the paper cites x.ai/news/grok-2 —
                            we use the open Grok-1 config as the stand-in and
                            label it "grok")
  * Qwen3-Coder           — QwenLM tech report (30B-A3B: 128 experts, top-8)
  * Llama3-8B             — meta-llama HF card (1M-token SP deployment à la
                            §6.3 long-context setup)
"""
from __future__ import annotations

from ..configs.base import ArchConfig

__all__ = ["PAPER_MODELS"]

MIXTRAL_8X7B = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, d_expert=14336,
    source="hf:mistralai/Mixtral-8x7B-Instruct-v0.1",
)

MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, d_expert=16384,
    source="hf:mistralai/Mixtral-8x22B-Instruct-v0.1",
)

DBRX = ArchConfig(
    name="dbrx", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv=8, d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, d_expert=10752,
    source="databricks:dbrx",
)

GROK = ArchConfig(
    name="grok", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, d_expert=32768,
    source="hf:xai-org/grok-1 (stand-in for Grok-2)",
)

QWEN3_CODER = ArchConfig(
    name="qwen3-coder", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv=4, d_ff=6144, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, d_expert=768,
    source="qwen3-coder-30b-a3b tech report",
)

LLAMA3_8B = ArchConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=128256,
    source="hf:meta-llama/Meta-Llama-3-8B",
)

PAPER_MODELS = {
    m.name: m
    for m in (MIXTRAL_8X7B, MIXTRAL_8X22B, DBRX, GROK, QWEN3_CODER, LLAMA3_8B)
}
