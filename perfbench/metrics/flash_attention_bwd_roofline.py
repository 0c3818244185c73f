"""The attention backward's share of its roofline over the traced
training steps: each layer's bound (``counts.flash_bwd_work`` at the
step's B x T) over the device time of its kernels (delta, dK/dV, the
split sum, dQ), in %."""
from perfbench.lib import counts
from perfbench.lib.trace import kernel_time


def read(record):
    t, tr = record.get("train"), record.get("trace")
    if not t or tr is None or not t["traced_steps"]:
        return None
    cfg = record["cfg"]
    works = [counts.flash_bwd_work(cfg, t["batch"], t["seq"])] * (
        t["traced_steps"] * cfg["num_hidden_layers"])
    secs = kernel_time(tr.ops, counts.KERNELS)["flash_attention_bwd"]
    got = counts.roofline_pct(works, secs)
    return None if got is None else got[0]
