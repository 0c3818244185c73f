"""repro_torch.configs — the architectures the port serves so far (exact
public configs + reduced smoke variants): the dense smollm-360m, the
attention-free SSM mamba2-1.3b, the hybrid recurrentgemma-9b and the
mixture of experts deepseek-moe-16b."""
from .base import ArchConfig, ShapeCell, SHAPES
from . import deepseek_moe_16b, mamba2_1_3b, recurrentgemma_9b, smollm_360m

_MODULES = (smollm_360m, mamba2_1_3b, recurrentgemma_9b, deepseek_moe_16b)
ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCHS", "SMOKES", "get_arch"]
