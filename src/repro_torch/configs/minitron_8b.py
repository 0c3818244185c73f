"""minitron-8b — dense (pruned nemotron), 32L d_model=4096 32H (GQA kv=8)
d_ff=16384 vocab=256000. [arXiv:2407.14679; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=16384,
    vocab=256000,
    source="arXiv:2407.14679",
)

SMOKE = ArchConfig(
    name="minitron-8b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv=2, d_ff=256, vocab=512,
    source="reduced",
)
