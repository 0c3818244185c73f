"""Blocking host transfers a decode step makes: the program's counter
``host_syncs`` (a bump for each copy of the inputs in and of the tokens
out that crossed to or from the card without ``non_blocking``, as
``repro_torch.tracing.syncs`` judges it) over the traced window's
``engine.step`` spans."""
from perfbench.lib.spans import decode_window


def read(record):
    w = decode_window(record)
    return None if w is None else w.syncs / len(w.steps)
