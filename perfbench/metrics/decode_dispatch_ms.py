"""Host milliseconds of ``Model.decode_step`` a decode step (the program's
``model.decode_step`` spans, entry to return: embedding, every layer's
dispatch and the logits), over the traced window's steps."""
from perfbench.lib.spans import DISPATCH, decode_window


def read(record):
    w = decode_window(record)
    return None if w is None else w.per_step_ms(DISPATCH)
