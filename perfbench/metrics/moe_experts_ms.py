"""Device milliseconds a decode step spends in the expert layers' routed
experts (the program's device section ``moe.experts``), summed over the
layers, over the traced window's ``engine.step`` spans."""
from perfbench.lib.mla_moe_counts import per_step_ms


def read(record):
    return per_step_ms(record, "moe.experts")
