"""MLA's attention cores' share of their roofline over the traced window,
in %: each layer's bound at the live lengths (each live key's latent and
rope key read once, 2 * heads * (576 + 512) operations a (query, key)
pair; ``lib/mla_moe_counts.py``) over the device time of the section
``mla.attend``, whatever implements the cores."""
from perfbench.lib.mla_moe_counts import mla_roofline


def read(record):
    return mla_roofline(record)
