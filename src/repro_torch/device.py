"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "needs_grad"]


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


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when grad is enabled and a tensor (None is skipped) requires a
    gradient: a kernel's wrapper then goes through its autograd Function,
    since autograd cannot see a ctypes launch."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
