"""Entry points of the model's kernels.

``attention`` (q:[B,T,H,D], k/v:[B,S,Hk,D]), ``decode_attention``
(q:[B,H,D], k/v:[B,S,Hk,D], lengths:[B]), both with an optional int32
``kv_map`` [H] sending query heads to the Hk stored KV heads, ``ssd``
(Mamba2 SSD) and ``rglru`` (the RG-LRU recurrence, a/x:[B,T,W]) run the
Hopper kernels on CUDA tensors and plain PyTorch on CPU tensors. There is
no switch and no fallback: a CUDA tensor the kernel cannot take raises.

Gradients: ``attention``, ``ssd`` and ``rglru`` are differentiable on both
devices through their autograd Functions (``FlashAttentionFn``,
``SsdChunkedFn``, ``RglruScanFn``, taken by the kernels' wrappers
``flash_attention``, ``ssd_chunked`` and ``rglru_scan``), only when grad
is enabled and an input needs a gradient: on CUDA tensors the backward
kernels run (``flash_attention_bwd``, ``ssd_chunked_bwd``,
``rglru_scan_bwd``), on CPU tensors their plain versions, the formulas
those kernels implement (the JAX package takes the same gradients by
autodiff of its oracles). A gradient through ``ssd`` cannot write
``out_state`` in place.
``decode_attention`` is never on a training path.
"""
from ..device import needs_grad
from .decode_attention import decode_attention
from .flash_attention import flash_attention as attention
from .rglru import rglru_scan as rglru
from .ssd_scan import ssd_chunked, ssd_plain

__all__ = ["attention", "decode_attention", "ssd", "rglru"]


def ssd(x, B, C, dt, A, D, init_state=None, out_state=None):
    """Mamba2 SSD. x: [Bz,T,H,hd]; B/C: [Bz,T,N]; dt: [Bz,T,H]; A/D: [H].
    Returns (y [Bz,T,H,hd], final_state [Bz,H,hd,N]), float32; the final
    state goes into ``out_state`` when given (it may be ``init_state``).

    On the CPU without a gradient this is the JAX package's dispatch
    without Pallas (``ssd_scan.ssd_plain``): the chunked dual form above 16
    steps, the sequential recurrence otherwise. Everything else goes to
    ``ssd_chunked``, which takes a gradient through ``SsdChunkedFn`` (whose
    CPU forward is that same dispatch).
    """
    if x.device.type == "cpu" and not needs_grad(x, B, C, dt, A, D,
                                                 init_state):
        y, s = ssd_plain(x, B, C, dt, A, D, init_state)
        return y, (s if out_state is None else out_state.copy_(s))
    return ssd_chunked(x, B, C, dt, A, D, init_state=init_state,
                       out_state=out_state)
