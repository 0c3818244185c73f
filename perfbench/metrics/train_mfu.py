"""The operations of training steps (forward and a backward of twice its
products; ``counts.train_flops``) over their time at the bf16 peak, in %:
the window's steps that ran untraced, from the end of the traced ones to
the end of the last."""
from perfbench.lib import counts


def read(record):
    t = record.get("train")
    if not t or not t["untraced_steps"] or t["untraced_s"] <= 0:
        return None
    flops = t["untraced_steps"] * counts.train_flops(
        record["cfg"], t["batch"], t["seq"])
    return 100.0 * flops / (t["untraced_s"] * counts.PEAK_FLOPS_BF16)
