"""RG-LRU linear recurrence: the Hopper kernel ``csrc/rglru_scan.cu``, its
plain PyTorch version, the wrapper, its launch plan and the kernel's cost
count.

Replaces the TPU kernel ``repro/kernels/rglru.py::rglru_scan`` (Pallas).
The TPU kernel solves each time chunk with an associative scan across its
vector lanes and carries the state from chunk to chunk in order; on the
H100 the recurrence is bound by bytes (one multiply-add per element read),
so the kernel runs it directly, one thread per channel and time chunk of
``CHUNK`` steps with the steps in registers, every chunk at once in one
pass: each chunk's carry comes from its predecessors by a decoupled
look-back over flags that the call clears first (the reasons and the
layout are in the source).

The backward, ``rglru_scan_bwd`` (``csrc/rglru_scan_bwd.cu``), is the same
one-pass look-back run from the last chunk to the first; ``RglruScanFn``
binds both to autograd.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``rglru_scan.launches`` and ``rglru_scan_bwd.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import needs_grad
from . import _build, meta
from .ref import rglru_ref, rglru_scan_bwd_plain

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_cost", "rglru_plan",
           "RglruPlan", "CHUNK", "THREADS", "rglru_scan_bwd",
           "rglru_scan_bwd_plain", "rglru_bwd_cost", "RglruScanFn"]

#: time steps per thread; a longer T is cut into chunks of this many
CHUNK = 64
#: channels per block, one a thread
THREADS = 64

#: the plain PyTorch version of the kernel: the sequential recurrence
rglru_scan_plain = rglru_ref


def rglru_cost(B: int, T: int, W: int, with_init: bool
               ) -> Tuple[float, float]:
    """(flops, bytes) of one call: one multiply-add per element, float32 a
    and x read once, h written once, the final state written and the
    initial state (when given) read."""
    flops = 2.0 * B * T * W
    return flops, 4.0 * (3 * B * T * W + (2 if with_init else 1) * B * W)


class RglruPlan(NamedTuple):
    """One launch of ``csrc/rglru_scan.cu`` (or of ``rglru_scan_bwd.cu``,
    which cuts time and channels the same way), as the kernel sees it."""
    chunks: int         # nc = max(1, ceil(T / CHUNK)) time chunks
    channel_blocks: int  # nwb = ceil(W / THREADS)
    grid: int           # blocks: nc * B * nwb
    flags: int          # int32 flags, the ticket first (0 for one chunk)
    carries: int        # float32 carries [3, B, nc-1, W] (0 for one chunk)


def rglru_bwd_cost(B: int, T: int, W: int, with_init: bool,
                   with_dsf: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one backward call: an add and two multiplies per
    element, float32 a, h and dh read once, dx and da written once, the
    initial state read and its gradient written when there is one, the
    final state's adjoint read when given."""
    flops = 3.0 * B * T * W
    return flops, 4.0 * (5 * B * T * W + (2 * with_init + with_dsf) * B * W)


def rglru_plan(B: int, T: int, W: int) -> RglruPlan:
    nc = max(1, -(-T // CHUNK))
    nwb = -(-W // THREADS)
    many = nc > 1
    return RglruPlan(nc, nwb, nc * B * nwb,
                     1 + B * nwb * nc if many else 0,
                     3 * B * (nc - 1) * W if many else 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 7 + [I] * 6 + [L] * 4 + [I, P]
        fn.restype = ctypes.c_int
    return lib


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a/x: [B,T,W] float32; init_state: [B,W] float32 or None (zeros).
    Returns (h [B,T,W], final_state [B,W]), float32. ``init_state`` is only
    read. A gradient goes through ``RglruScanFn`` on either device. On meta
    tensors, outputs of the kernel's shapes (``kernels.meta``)."""
    if needs_grad(a, x, init_state):
        return RglruScanFn.apply(a, x, init_state)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, x, init_state)
    if a.device.type == "meta":
        B, T, W = a.shape
        meta.count("rglru_scan", rglru_cost(B, T, W, init_state is not None)[0])
        return meta.empty(B, T, W), meta.empty(B, W)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for {a.device}")
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a has shape {tuple(a.shape)}, "
                         "expected [B, T, W]")
    B, T, W = a.shape
    got = {"a": a, "x": x}
    want = {"a": (B, T, W), "x": (B, T, W)}
    if init_state is not None:
        got["init_state"], want["init_state"] = init_state, (B, W)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"rglru_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan: {name} is {t.dtype}; the kernel "
                             "takes float32")
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} on {t.device}, a on "
                             f"{a.device}")
    a, x = (t if t.stride(-1) == 1 else t.contiguous() for t in (a, x))
    if init_state is not None:
        init_state = init_state.contiguous()
    h = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    sf = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if sf.numel() == 0:
        return h, sf
    plan = rglru_plan(B, T, W)
    dev = a.device
    carries = (torch.empty(plan.carries, dtype=torch.float32, device=dev)
               if plan.carries else None)
    flags = (torch.empty(plan.flags, dtype=torch.int32, device=dev)
             if plan.flags else None)
    v16 = W % 4 == 0 and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
                             and t.stride(1) % 4 == 0 for t in (a, x))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().rglru_scan_fwd(
        a.data_ptr(), x.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        h.data_ptr(), sf.data_ptr(),
        None if carries is None else carries.data_ptr(),
        None if flags is None else flags.data_ptr(), B, T, W, CHUNK, THREADS,
        plan.flags, a.stride(0), a.stride(1), x.stride(0), x.stride(1),
        int(v16), stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    rglru_scan.launches += 1
    return h, sf


rglru_scan.launches = 0


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan_bwd")
    fn = lib.rglru_scan_bwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 6 + [L] * 6 + [I, P]
        fn.restype = ctypes.c_int
    return lib


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   init_state: Optional[torch.Tensor], dh: torch.Tensor,
                   dhf: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """The gradient of ``rglru_scan``: a and the forward's h [B,T,W], its
    initial state [B,W] (or None), ``dh`` [B,T,W] and ``dhf`` [B,W] (the
    final state's adjoint; None for zeros), all float32. Returns (da, dx,
    d init_state), the last None without an initial state. On meta
    tensors, outputs of the kernel's shapes (``kernels.meta``)."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_plain(a, h, init_state, dh, dhf)
    if a.device.type == "meta":
        B, T, W = a.shape
        meta.count("rglru_scan_bwd", rglru_bwd_cost(
            B, T, W, init_state is not None, dhf is not None)[0])
        return (meta.empty(B, T, W), meta.empty(B, T, W),
                None if init_state is None else meta.empty(B, W))
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: no kernel for {a.device}")
    B, T, W = a.shape
    for name, t, shape in (("a", a, (B, T, W)), ("h", h, (B, T, W)),
                           ("dh", dh, (B, T, W)), ("init_state", init_state,
                                                   (B, W)),
                           ("dhf", dhf, (B, W))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"rglru_scan_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan_bwd: {name} is {t.dtype}; the "
                             "kernel takes float32")
        if t.device != a.device:
            raise ValueError(f"rglru_scan_bwd: {name} on {t.device}, a on "
                             f"{a.device}")
    a, h, dh = (t if t.stride(-1) == 1 else t.contiguous() for t in (a, h, dh))
    if init_state is not None:
        init_state = init_state.contiguous()
    if dhf is not None:
        dhf = dhf.contiguous()
    dev = a.device
    dx = torch.empty((B, T, W), dtype=torch.float32, device=dev)
    da = torch.empty_like(dx)
    ds0 = (torch.empty((B, W), dtype=torch.float32, device=dev)
           if init_state is not None else None)
    if B * W == 0:
        return da, dx, ds0
    plan = rglru_plan(B, T, W)
    carries = (torch.empty(plan.carries, dtype=torch.float32, device=dev)
               if plan.carries else None)
    flags = (torch.empty(plan.flags, dtype=torch.int32, device=dev)
             if plan.flags else None)
    v16 = W % 4 == 0 and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
                             and t.stride(1) % 4 == 0 for t in (a, dh, h))

    def ptr(t):
        return None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_lib().rglru_scan_bwd(
        *map(ptr, (a, h, dh, init_state, dhf, dx, da, ds0, carries, flags)),
        B, T, W, CHUNK, THREADS, plan.flags, a.stride(0), a.stride(1),
        h.stride(0), h.stride(1), dh.stride(0), dh.stride(1), int(v16),
        stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed: "
                           f"cudaError {err}")
    rglru_scan_bwd.launches += 1
    return da, dx, ds0


rglru_scan_bwd.launches = 0


class RglruScanFn(torch.autograd.Function):
    """The RG-LRU recurrence with the backward of ``rglru_scan_bwd``; saves
    a, the output h and the initial state (4 B T W bytes beside a). On
    CUDA tensors both directions launch the kernels; on CPU tensors they
    run the plain versions."""

    @staticmethod
    def forward(ctx, a, x, init_state):
        ctx.set_materialize_grads(False)
        h, s = rglru_scan(a, x, init_state)
        ctx.save_for_backward(a, h, init_state)
        return h, s

    @staticmethod
    def backward(ctx, dh, dhf):
        a, h, init_state = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        return rglru_scan_bwd(a, h, init_state, dh, dhf)
