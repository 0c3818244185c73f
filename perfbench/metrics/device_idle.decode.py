"""Share of the traced window in which no operation ran on the device:
1 - busy / window, in %."""
from perfbench.lib.readings import idle_pct


def read(record):
    return idle_pct(record, "decode")
