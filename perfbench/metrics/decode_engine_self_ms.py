"""Host milliseconds a decode step spends in the engine's own work: the
program's ``engine.step`` less its ``model.decode_step`` and ``engine.sync``
children. That is the inputs' copies (``engine.inputs``), the slots'
bookkeeping (``engine.retire``) and the rest of the call; with dispatch and
the wait it makes up the step. Over the traced window's steps."""
from perfbench.lib.spans import DISPATCH, STEP, SYNC, decode_window


def read(record):
    w = decode_window(record)
    if w is None:
        return None
    own = w.total_ns(STEP) - w.total_ns(DISPATCH) - w.total_ns(SYNC)
    return own / 1e6 / len(w.steps)
