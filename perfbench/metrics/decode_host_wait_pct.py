"""Share of ``DecodeBatch.step`` the host waits on the step's blocking read
of its tokens (the program's ``engine.sync`` over its ``engine.step``
spans), in %: at 100 the device sets the pace, near 0 the host does. A
diagnostic, read beside ``tpot_p95_ms``: a faster host raises it, and so
does a slower device."""
from perfbench.lib.spans import STEP, SYNC, decode_window


def read(record):
    w = decode_window(record)
    if w is None:
        return None
    return 100.0 * w.total_ns(SYNC) / w.total_ns(STEP)
