"""repro_torch.configs — the architectures the port serves so far (exact
public configs + reduced smoke variants)."""
from .base import ArchConfig, ShapeCell, SHAPES
from . import smollm_360m

ARCHS = {m.CONFIG.name: m.CONFIG for m in (smollm_360m,)}
SMOKES = {m.CONFIG.name: m.SMOKE for m in (smollm_360m,)}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCHS", "SMOKES", "get_arch"]
