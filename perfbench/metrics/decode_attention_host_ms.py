"""Host milliseconds a decode step spends in the decode attention wrapper's
CUDA branch (the program's ``kernel.decode_attention`` spans: checks,
buffers, the launch), summed over the step's layers, over the traced
window's steps."""
from perfbench.lib.spans import KERNEL, decode_window


def read(record):
    w = decode_window(record)
    return None if w is None else w.per_step_ms(KERNEL)
