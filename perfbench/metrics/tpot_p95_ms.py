"""95th percentile of every gap between consecutive tokens of every
sequence of the decode batch, each gap ending in the window (the first
from the hand-over), on the host clock."""
from perfbench.lib.readings import gap_percentile_ms


def read(record):
    return gap_percentile_ms(record.get("decode"), 95)
