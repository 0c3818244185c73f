"""deepseek-v3-671b — MLA + fine-grained MoE, 61L d_model=7168 128H
d_ff=2048(expert), vocab=129280, 1 shared + 256 routed top-8, first 3 dense,
MTP head. [arXiv:2412.19437; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv=128, d_ff=18432,
    vocab=129280,
    n_experts=256, top_k=8, n_shared=1, d_expert=2048, first_dense=3,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    mtp=True,
    source="arXiv:2412.19437",
)

SMOKE = ArchConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    n_experts=8, top_k=2, n_shared=1, d_expert=64, first_dense=1,
    use_mla=True, kv_lora_rank=32, q_lora_rank=48,
    rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
    mtp=True,
    source="reduced",
)
