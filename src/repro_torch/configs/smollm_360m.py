"""smollm-360m — dense llama-arch small, 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560,
    vocab=49152, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=3, n_kv=1, d_ff=192, vocab=512,
    tie_embeddings=True, source="reduced",
)
