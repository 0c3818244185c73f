"""99th percentile of every gap between consecutive tokens of every
sequence, each gap ending in the window (the first gap waits for the rest
of its burst's prefills), on the host clock."""
from perfbench.lib.readings import gap_percentile_ms


def read(record):
    return gap_percentile_ms(record.get("serve"), 99)
