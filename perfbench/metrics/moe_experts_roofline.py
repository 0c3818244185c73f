"""The held experts' share of their roofline over the traced window, in %:
the weights of each held expert that some pair reached in a step, read
once, and the pairs' rows in and out (the program's counter
``moe_held_pairs``; ``lib/mla_moe_counts.py``), over the device time of
the section ``moe.experts``."""
from perfbench.lib.mla_moe_counts import experts_roofline


def read(record):
    return experts_roofline(record)
