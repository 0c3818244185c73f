"""recurrentgemma-9b — hybrid RG-LRU + local attention (2 recurrent : 1
attn), 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000, window 2048.
[arXiv:2402.19427; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
    vocab=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), window=2048, rglru_width=4096,
    source="arXiv:2402.19427",
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=3, d_model=128, n_heads=2, n_kv=1, d_ff=256, vocab=512,
    head_dim=64, block_pattern=("rec", "rec", "attn"), window=16,
    rglru_width=128, source="reduced",
)
