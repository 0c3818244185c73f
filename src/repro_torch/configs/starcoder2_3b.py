"""starcoder2-3b — dense, 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GQA + RoPE. [arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288,
    vocab=49152,
    source="arXiv:2402.19173",
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=192, vocab=512,
    source="reduced",
)
