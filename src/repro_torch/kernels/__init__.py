"""Kernels of the port.

    flash_attention.py / decode_attention.py / ssd_scan.py / rglru.py —
        hand-written Hopper CUDA kernels (sources in ``csrc/``), each
        with its plain PyTorch version, a wrapper and a launch counter;
        the attention and scan backwards with their autograd Functions
    attn_split.py — the attention kernels' q->kv map and split-KV merge;
        ``attn_merge``, the merge of a sequence-sharded decode's ranks
        (``csrc/attn_merge.cu``)
    ops.py    — the entry points the model calls
    ref.py    — plain PyTorch oracles (semantics of record)
    _build.py — builds ``csrc/*.cu`` with nvcc at first use
"""
from . import ops, ref

__all__ = ["ops", "ref"]
