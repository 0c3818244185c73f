"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "refuse_grad"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``NotImplementedError`` when autograd would need the gradient
    of a kernel that has no backward: its ctypes launch would hand autograd
    a constant, and the gradients upstream would be silently wrong."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the Hopper kernel has no backward yet (ROADMAP queue 2 "
            "#8, the scans' backward kernels); train this model on the CPU "
            "(device='cpu'), where autograd runs the plain version")
