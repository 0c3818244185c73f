"""qwen1.5-32b — dense, 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B scaled family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392,
    vocab=152064, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-32B",
)

SMOKE = ArchConfig(
    name="qwen1.5-32b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256,
    vocab=512, qkv_bias=True,
    source="reduced",
)
