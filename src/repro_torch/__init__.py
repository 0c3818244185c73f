"""repro_torch — the PyTorch / CUDA port of the MFS serving system.

The control plane (``core``, ``netsim``, ``configs``, ``simcluster.hw``) is
a byte-for-byte copy of the JAX package's; the data plane (``kernels``,
``models``, ``serving``, ``launch``) is re-implemented in PyTorch, with the
attention hot spots as hand-written CUDA kernels for Hopper (``csrc/``).
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own.
"""
