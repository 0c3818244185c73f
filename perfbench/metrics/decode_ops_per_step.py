"""Device operations a decode step runs: those of the traced window that
start inside one of the program's ``engine.step`` spans, over the steps."""
from perfbench.lib.spans import decode_window


def read(record):
    w = decode_window(record)
    if w is None:
        return None
    steps = sorted((s.t0_ns, s.t1_ns) for s in w.steps)
    n, i = 0, 0
    for _, start, _ in record["trace"].ops:
        while i < len(steps) and steps[i][1] < start:
            i += 1
        if i == len(steps):
            break
        n += steps[i][0] <= start
    return n / len(steps)
