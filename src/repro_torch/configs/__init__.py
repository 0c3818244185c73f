"""repro_torch.configs — the architectures the port serves so far (exact
public configs + reduced smoke variants): the dense smollm-360m,
minitron-8b, starcoder2-3b and qwen1.5-32b, the attention-free SSM
mamba2-1.3b, the hybrid recurrentgemma-9b and the mixture of experts
deepseek-moe-16b. ``get_arch`` also resolves the paper's evaluation models
(``simcluster.papermodels``), as the JAX package's does."""
from .base import ArchConfig, ShapeCell, SHAPES
from . import (deepseek_moe_16b, mamba2_1_3b, minitron_8b, qwen1_5_32b,
               recurrentgemma_9b, smollm_360m, starcoder2_3b)

_MODULES = (qwen1_5_32b, minitron_8b, starcoder2_3b, smollm_360m,
            recurrentgemma_9b, deepseek_moe_16b, mamba2_1_3b)
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
