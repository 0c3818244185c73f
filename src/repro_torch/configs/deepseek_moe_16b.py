"""deepseek-moe-16b — fine-grained MoE, 28L d_model=2048 16H (kv=16, MHA)
d_ff=1408(expert), vocab=102400, 64 routed top-6 + 2 shared, first layer
dense. [arXiv:2401.06066; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=10944,
    vocab=102400,
    n_experts=64, top_k=6, n_shared=2, d_expert=1408, first_dense=1,
    source="arXiv:2401.06066",
)

SMOKE = ArchConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    n_experts=8, top_k=2, n_shared=1, d_expert=64, first_dense=1,
    source="reduced",
)
