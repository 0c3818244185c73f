"""repro_torch.models — the dense decoder in PyTorch, driven by ArchConfig."""
from .convert import from_jax_params
from .lm import Model, Segment, build_model, plan_segments

__all__ = ["Model", "Segment", "build_model", "plan_segments",
           "from_jax_params"]
