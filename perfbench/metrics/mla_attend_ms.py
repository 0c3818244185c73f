"""Device milliseconds a decode step spends in MLA's absorbed attention
core (the program's device section ``mla.attend``: ``q_lat`` to
``ctx W_vb``, the projections left out), summed over the layers, over
the traced window's ``engine.step`` spans."""
from perfbench.lib.mla_moe_counts import per_step_ms


def read(record):
    return per_step_ms(record, "mla.attend")
