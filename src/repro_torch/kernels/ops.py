"""Attention entry points of the model.

``attention`` (q:[B,T,H,D], k/v:[B,S,H,D], heads already aligned) and
``decode_attention`` (q:[B,H,D], k/v:[B,S,H,D], lengths:[B]) run the Hopper
kernels on CUDA tensors and their plain PyTorch versions on CPU tensors.
There is no switch and no fallback: a CUDA tensor the kernel cannot take
raises.
"""
from .decode_attention import decode_attention
from .flash_attention import flash_attention as attention

__all__ = ["attention", "decode_attention"]
