"""(Token, expert) pairs that reached the experts this chip holds, over
every expert layer, a decode step: the program's counter
``moe_held_pairs`` over the traced window's ``engine.step`` spans."""
from perfbench.lib.mla_moe_counts import pairs_per_step


def read(record):
    return pairs_per_step(record)
