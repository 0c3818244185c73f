"""Entry points of the model's kernels.

``attention`` (q:[B,T,H,D], k/v:[B,S,Hk,D]), ``decode_attention``
(q:[B,H,D], k/v:[B,S,Hk,D], lengths:[B]), both with an optional int32
``kv_map`` [H] sending query heads to the Hk stored KV heads, ``ssd``
(Mamba2 SSD) and ``rglru`` (the RG-LRU recurrence, a/x:[B,T,W]) run the
Hopper kernels on CUDA tensors and plain PyTorch on CPU tensors. There is
no switch and no fallback: a CUDA tensor the kernel cannot take raises.

Gradients: ``attention`` is differentiable on both devices (the backward
kernel on CUDA, see ``flash_attention.FlashAttentionFn``); ``decode_attention``
is never on a training path. ``ssd`` and ``rglru`` keep autograd through
their plain versions on the CPU, as the JAX package differentiates its
oracles; their kernels have no backward yet, so their wrappers refuse a
CUDA tensor that needs a gradient rather than lose it
(``device.refuse_grad``).
"""
from .decode_attention import decode_attention
from .flash_attention import flash_attention as attention
from .ref import ssd_dual, ssd_ref
from .rglru import rglru_scan as rglru
from .ssd_scan import ssd_chunked

__all__ = ["attention", "decode_attention", "ssd", "rglru"]


def ssd(x, B, C, dt, A, D, init_state=None, out_state=None):
    """Mamba2 SSD. x: [Bz,T,H,hd]; B/C: [Bz,T,N]; dt: [Bz,T,H]; A/D: [H].
    Returns (y [Bz,T,H,hd], final_state [Bz,H,hd,N]), float32; the final
    state goes into ``out_state`` when given (it may be ``init_state``).

    On the CPU this is the JAX package's dispatch without Pallas: the
    chunked dual form above 16 steps, the sequential recurrence otherwise.
    """
    if x.device.type == "cpu":
        ref = ssd_dual if x.shape[1] > 16 else ssd_ref
        y, s = ref(x, B, C, dt, A, D, init_state=init_state)
        return y, (s if out_state is None else out_state.copy_(s))
    return ssd_chunked(x, B, C, dt, A, D, init_state=init_state,
                       out_state=out_state)
