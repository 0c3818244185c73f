"""Mamba2 SSD scan: the Hopper kernels ``csrc/ssd_scan.cu``, their plain
PyTorch version, the wrapper, its launch plan and the function's cost count.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_chunked``
(Pallas). Two kernels, picked by T alone (``ssd_plan``): above
``SSD_REC_MAX_T`` steps the chunked dual form the TPU kernel computes, its
four products on TF32 tensor cores in 3xTF32; at or below it (decode, short
suffixes) the recurrence with the state in registers. Both add ``D * x``
in their epilogue and may write the final state over the initial one
(``out_state``). The reasons and the layouts are in the source.

A CPU tensor goes to the plain version; a CUDA tensor launches a kernel or
raises. ``ssd_chunked.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import refuse_grad
from . import _build
from .ref import ssd_dual

__all__ = ["ssd_chunked", "ssd_chunked_plain", "ssd_cost", "ssd_plan",
           "SsdPlan", "STATE_DIMS", "SSD_REC_MAX_T"]

#: state sizes N the kernel is compiled for
STATE_DIMS = (16, 32, 64, 128)

#: at or below this many steps the recurrence runs, above it the dual form
#: (both measured on an H100 at T = 16, 32, 48, 64 by tools/scan_probe.py:
#: the recurrence is faster up to 32 steps, the dual form from 48)
SSD_REC_MAX_T = 32

#: the plain PyTorch version of the kernel: the chunked dual form, the
#: function the TPU kernel computes (``ref.ssd_dual``)
ssd_chunked_plain = ssd_dual


def ssd_cost(Bz: int, T: int, H: int, hd: int, N: int, *,
             with_init: bool = True) -> Tuple[float, float]:
    """(flops, bytes) of one call, independent of how the kernel tiles time.

    Flops are the recurrence's, ``4 * Bz * T * H * hd * N``: per state
    element and step one multiply-add for the update and one for the
    readout ``C_t s_t``. Bytes read each float32 input once
    (x, B, C, dt, A, D and the initial state when given) and write y and the
    final state once.
    """
    flops = 4.0 * Bz * T * H * hd * N
    state = Bz * H * hd * N
    elems = (2 * Bz * T * H * hd          # x in, y out
             + 2 * Bz * T * N             # B, C
             + Bz * T * H + 2 * H         # dt, A, D
             + state * (2 if with_init else 1))
    return flops, 4.0 * elems


class SsdPlan(NamedTuple):
    """One call of ``csrc/ssd_scan.cu``, as the kernels see it."""
    path: str        # "dual" (chunked dual form) or "recurrence"
    chunk: int       # time steps staged a pass (Q of the dual form)
    rows: int        # state rows (of hd) a block
    threads: int     # threads a block (the dual form: 16 product warps
                     # and 4 staging warps)
    grid: int        # blocks: Bz * H * ceil(hd / rows)
    smem: int        # shared bytes a block (the kernel checks it)
    gram: int        # floats of G = C B^T, [Bz, nc, Q, Q] (dual form only)


def ssd_plan(Bz: int, T: int, H: int, hd: int, N: int, *,
             path: Optional[str] = None) -> SsdPlan:
    """The launch ``ssd_chunked`` makes; ``path`` forces one kernel (for
    timing both at the threshold), otherwise T picks it. Shared bytes
    mirror the kernels' ``Smem<N>`` structs of float arrays."""
    if path is None:
        path = "dual" if T > SSD_REC_MAX_T else "recurrence"
    if path == "dual":
        Q, R = 64, 32
        floats = (2 * 2 * Q * (N + 4)       # B, C: two stages, padded rows
                  + 2 * Q * (R + 8)         # x: two stages
                  + 3 * 2 * Q               # dt, cs, w: two stages
                  + 2 * Q * (Q + 4)         # G (o L): two stages
                  + R * (N + 4))            # the state
        return SsdPlan(path, Q, R, 16 * 32 + 4 * 32, Bz * H * -(-hd // R),
                       4 * floats, Bz * -(-T // Q) * Q * Q)
    if path != "recurrence":
        raise ValueError(f"ssd_plan: no path {path!r}")
    Q, owners = 16, (8 if N >= 32 else 4)
    R = 128 // owners
    floats = (2 * 2 * Q * N                 # B, C: two stages
              + 2 * Q * R + 2 * Q           # x, dt: two stages
              + Q * R * owners + Q)         # partial readouts, decays
    return SsdPlan(path, Q, R, 128, Bz * H * -(-hd // R), 4 * floats, 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 8 + [L] * 10 + [P]
        fn.restype = ctypes.c_int
    return lib


def _last_dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its last axis is unit-stride, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if every row along its last axis is dense and starts on
    16 bytes (the kernel copies B and C rows in 16-byte pieces), else an
    aligned contiguous copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(st % 4 == 0 for st in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(name: str, t: torch.Tensor, shape, x: torch.Tensor) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_chunked: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"ssd_chunked: {name} is {t.dtype}; the kernel "
                         "takes float32")
    if t.device != x.device:
        raise ValueError(f"ssd_chunked: {name} on {t.device}, x on "
                         f"{x.device}")


def ssd_chunked(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                init_state: Optional[torch.Tensor] = None,
                out_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [Bz,T,H,hd]; B/C: [Bz,T,N]; dt: [Bz,T,H]; A/D: [H]; init_state:
    [Bz,H,hd,N] or None. All float32. Returns (y [Bz,T,H,hd], final_state
    [Bz,H,hd,N]), float32; y includes ``D * x``. The final state is written
    into ``out_state`` when given (contiguous; it may be ``init_state``
    itself, which decode uses to update its cache in place), else into a
    new tensor; ``init_state`` is otherwise only read."""
    if x.device.type == "cpu":
        y, s = ssd_chunked_plain(x, B, C, dt, A, D, init_state)
        return y, (s if out_state is None else out_state.copy_(s))
    refuse_grad("ssd_chunked", x, B, C, dt, A, D, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked: no kernel for {x.device}")
    Bz, T, H, hd = x.shape
    N = B.shape[-1]
    _check("x", x, (Bz, T, H, hd), x)
    for name, t, shape in (("B", B, (Bz, T, N)), ("C", C, (Bz, T, N)),
                           ("dt", dt, (Bz, T, H)), ("A", A, (H,)),
                           ("D", D, (H,))):
        _check(name, t, shape, x)
    for name, t in (("init_state", init_state), ("out_state", out_state)):
        if t is not None:
            _check(name, t, (Bz, H, hd, N), x)
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_chunked: state size {N} not in {STATE_DIMS}")
    if out_state is not None and (not out_state.is_contiguous()
                                  or out_state.data_ptr() % 16):
        raise ValueError("ssd_chunked: out_state must be contiguous and "
                         "16-byte aligned")
    x = _last_dense(x)
    B, C = _rows16(B), _rows16(C)
    A, D = A.contiguous(), D.contiguous()
    if init_state is not None and (not init_state.is_contiguous()
                                   or init_state.data_ptr() % 16):
        init_state = init_state.clone(memory_format=torch.contiguous_format)
    y = torch.empty((Bz, T, H, hd), dtype=torch.float32, device=x.device)
    sf = out_state if out_state is not None else torch.empty(
        (Bz, H, hd, N), dtype=torch.float32, device=x.device)
    if sf.numel() == 0:
        return y.zero_(), sf
    return y, _launch(ssd_plan(Bz, T, H, hd, N), x, B, C, dt, A, D,
                      init_state, y, sf)


def _launch(plan: SsdPlan, x, B, C, dt, A, D, init_state, y, sf
            ) -> torch.Tensor:
    """One launch of ``plan`` on checked, aligned operands; returns sf."""
    Bz, T, H, hd = x.shape
    x16 = (x.data_ptr() % 16 == 0 and hd % 4 == 0
           and all(st % 4 == 0 for st in x.stride()[:3]))
    gram = (torch.empty(plan.gram, dtype=torch.float32, device=x.device)
            if plan.gram else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ssd_scan_fwd(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), A.data_ptr(),
        D.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), sf.data_ptr(), None if gram is None else gram.data_ptr(),
        int(x16), Bz, T, H, hd, B.shape[-1],
        1 if plan.path == "dual" else 0, plan.smem,
        x.stride(0), x.stride(1), x.stride(2), B.stride(0), B.stride(1),
        C.stride(0), C.stride(1), dt.stride(0), dt.stride(1), dt.stride(2),
        stream)
    if err:
        raise RuntimeError(f"ssd_chunked kernel launch failed ({plan.path}): "
                           f"cudaError {err}")
    ssd_chunked.launches += 1
    return sf


ssd_chunked.launches = 0
