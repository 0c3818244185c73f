"""Host milliseconds a ``DecodeBatch.step``, over the window's steps."""
from perfbench.lib.readings import step_ms


def read(record):
    return step_ms(record.get("decode"))
