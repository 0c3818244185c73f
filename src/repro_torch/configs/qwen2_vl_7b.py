"""qwen2-vl-7b — VLM backbone, 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE; the vision frontend is a stub providing patch
embeddings (input_specs). [arXiv:2409.12191; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944,
    vocab=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2409.12191",
)

SMOKE = ArchConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    qkv_bias=True, source="reduced",
)
