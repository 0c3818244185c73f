"""The traced window's decode steps' operations (MLA's projections and
its cores at the live lengths, the pairs routed to the held experts, the
shared experts, the dense layers' MLPs, the routers and the head;
``lib/mla_moe_counts.decode_flops``) over the host time in the steps at
the bf16 peak (989 TFLOP/s), in %."""
from perfbench.lib.mla_moe_counts import mfu


def read(record):
    return mfu(record)
