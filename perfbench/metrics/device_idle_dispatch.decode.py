"""Share of the traced window in which the device is idle while the host
is inside ``Model.decode_step`` (the program's ``model.decode_step`` spans,
whatever layer or kernel span lies open inside them), in %: each idle gap
goes to the span open at its middle, as ``DeviceTrace.idle_by_span``
labels them. Part of ``device_idle.decode``."""
from perfbench.lib.spans import DISPATCH, decode_window


def read(record):
    w = decode_window(record)
    if w is None:
        return None
    tr = record["trace"]
    idle = tr.idle_by_span(w.host_spans(DISPATCH)).get(DISPATCH, 0.0)
    return 100.0 * idle / tr.window_s
