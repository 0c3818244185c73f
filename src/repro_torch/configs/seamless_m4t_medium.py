"""seamless-m4t-medium — encoder-decoder, 12L(dec) + 12L(enc) d_model=1024
16H (kv=16) d_ff=4096 vocab=256206; the speech frontend is a stub providing
frame embeddings. [arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
    vocab=256206, enc_layers=12,
    source="arXiv:2308.11596",
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    enc_layers=2, source="reduced",
)
