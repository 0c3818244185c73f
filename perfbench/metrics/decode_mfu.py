"""The window's decode steps' operations over the host time in them at
the bf16 peak (989 TFLOP/s), in % (``readings.decode_mfu``)."""
from perfbench.lib.readings import decode_mfu


def read(record):
    return decode_mfu(record, record.get("decode"))
