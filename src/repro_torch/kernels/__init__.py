"""Attention kernels of the port.

    flash_attention.py / decode_attention.py — hand-written Hopper CUDA
        kernels (sources in ``csrc/``), each with its plain PyTorch version,
        a wrapper and a launch counter
    ops.py    — the entry points the model calls
    ref.py    — plain PyTorch oracles (semantics of record)
    _build.py — builds ``csrc/*.cu`` with nvcc at first use
"""
from . import ops, ref

__all__ = ["ops", "ref"]
