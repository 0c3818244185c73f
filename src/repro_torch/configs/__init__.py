"""repro_torch.configs — the architectures the port serves so far (exact
public configs + reduced smoke variants): the dense smollm-360m, the
attention-free SSM mamba2-1.3b and the hybrid recurrentgemma-9b."""
from .base import ArchConfig, ShapeCell, SHAPES
from . import mamba2_1_3b, recurrentgemma_9b, smollm_360m

_MODULES = (smollm_360m, mamba2_1_3b, recurrentgemma_9b)
ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCHS", "SMOKES", "get_arch"]
