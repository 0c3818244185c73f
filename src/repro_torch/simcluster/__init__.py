"""repro_torch.simcluster — hardware profiles of the analytic latency model."""
from .hw import HW, A100, H100, RTX3090, TPU_V5E

__all__ = ["HW", "A100", "H100", "RTX3090", "TPU_V5E"]
