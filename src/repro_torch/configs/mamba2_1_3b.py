"""mamba2-1.3b — SSM (SSD / state-space duality), 48L d_model=2048
attention-free, vocab=50280, ssm_state=128. [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

SMOKE = ArchConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv=0, d_ff=0, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, tie_embeddings=True,
    source="reduced",
)
