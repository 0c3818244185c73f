"""repro_torch.configs — every architecture of the JAX package (exact
public configs + reduced smoke variants): the dense smollm-360m,
minitron-8b, starcoder2-3b and qwen1.5-32b, the attention-free SSM
mamba2-1.3b, the hybrid recurrentgemma-9b, the mixtures of experts
deepseek-moe-16b and deepseek-v3-671b (MLA, MTP), the VLM backbone
qwen2-vl-7b and the encoder-decoder seamless-m4t-medium. ``get_arch`` also
resolves the paper's evaluation models (``simcluster.papermodels``), as
the JAX package's does."""
from .base import ArchConfig, ShapeCell, SHAPES
from . import (deepseek_moe_16b, deepseek_v3_671b, mamba2_1_3b, minitron_8b,
               qwen1_5_32b, qwen2_vl_7b, recurrentgemma_9b,
               seamless_m4t_medium, smollm_360m, starcoder2_3b)

_MODULES = (qwen1_5_32b, minitron_8b, starcoder2_3b, smollm_360m,
            recurrentgemma_9b, deepseek_moe_16b, deepseek_v3_671b,
            mamba2_1_3b, qwen2_vl_7b, seamless_m4t_medium)
ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    from ..simcluster.papermodels import PAPER_MODELS
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCHS", "SMOKES", "get_arch"]
