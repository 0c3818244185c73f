"""The prefill attention kernel's share of its roofline over the traced
window: the bound of each call (its operations at 989 TFLOP/s or its
bytes at 3.35 TB/s, the larger; ``counts.flash_fwd_work`` of each
prefill's new tokens over its cached prefix, every layer) over the
device time of ``flash_mma_kernel`` and the combines it launched, in %."""
from perfbench.lib import counts
from perfbench.lib.trace import kernel_time


def read(record):
    s, tr = record.get("serve"), record.get("trace")
    if not s or tr is None:
        return None
    cfg = record["cfg"]
    works = [counts.flash_fwd_work(cfg, 1, T, pre)
             for a, b, T, pre in s["prefill_calls"]
             if tr.t0_ns <= a and b <= tr.t1_ns] * cfg["num_hidden_layers"]
    secs = kernel_time(tr.ops, counts.KERNELS)["flash_attention"]
    got = counts.roofline_pct(works, secs)
    return None if got is None else got[0]
