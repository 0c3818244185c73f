"""Mamba2 SSD scan: the Hopper kernel ``csrc/ssd_scan.cu``, its plain
PyTorch version, the wrapper and the kernel's cost count.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_chunked``
(Pallas). The TPU kernel recasts the recurrence as chunked matrix products
for the MXU; in float32 on the H100 those would run on the CUDA cores, so
the kernel runs the recurrence itself with the ``[hd, N]`` state in
registers (the reasons and the layout are in the source). ``D * x`` is
added here, outside the kernel, as the TPU kernel's wrapper does.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``ssd_chunked.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import ssd_dual

__all__ = ["ssd_chunked", "ssd_chunked_plain", "ssd_cost", "STATE_DIMS"]

#: state sizes N the kernel is compiled for
STATE_DIMS = (16, 32, 64, 128)

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 8 + [I] * 5 + [L] * 10 + [P]
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


def ssd_chunked(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [Bz,T,H,hd]; B/C: [Bz,T,N]; dt: [Bz,T,H]; A/D: [H]; init_state:
    [Bz,H,hd,N] or None. All float32. Returns (y [Bz,T,H,hd], final_state
    [Bz,H,hd,N]), float32; y includes ``D * x``. ``init_state`` is only
    read."""
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, B, C, dt, A, D, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked: no kernel for {x.device}")
    Bz, T, H, hd = x.shape
    N = B.shape[-1]
    want = {"B": (Bz, T, N), "C": (Bz, T, N), "dt": (Bz, T, H), "A": (H,),
            "D": (H,)}
    got = {"B": B, "C": C, "dt": dt, "A": A, "D": D}
    if init_state is not None:
        want["init_state"], got["init_state"] = (Bz, H, hd, N), init_state
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunked: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_chunked: {name} is {t.dtype}; the kernel "
                             "takes float32")
        if t.device != x.device:
            raise ValueError(f"ssd_chunked: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"ssd_chunked: x is {x.dtype}; the kernel takes "
                         "float32")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_chunked: state size {N} not in {STATE_DIMS}")
    x = _last_dense(x)
    B, C = _rows16(B), _rows16(C)
    A = A.contiguous()
    if init_state is not None and (not init_state.is_contiguous()
                                   or init_state.data_ptr() % 16):
        init_state = init_state.clone(memory_format=torch.contiguous_format)
    y = torch.empty((Bz, T, H, hd), dtype=torch.float32, device=x.device)
    sf = torch.empty((Bz, H, hd, N), dtype=torch.float32, device=x.device)
    if sf.numel() == 0:
        return y.zero_(), sf
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ssd_scan_fwd(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), A.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), sf.data_ptr(), Bz, T, H, hd, N,
        x.stride(0), x.stride(1), x.stride(2), B.stride(0), B.stride(1),
        C.stride(0), C.stride(1), dt.stride(0), dt.stride(1), dt.stride(2),
        stream)
    if err:
        raise RuntimeError(f"ssd_chunked kernel launch failed: cudaError {err}")
    ssd_chunked.launches += 1
    y.addcmul_(x, D[None, None, :, None])          # D * x, outside the kernel
    return y, sf


ssd_chunked.launches = 0
