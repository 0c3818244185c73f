"""The decode attention kernel's share of its roofline over the traced
window, in % (``readings.decode_roofline``)."""
from perfbench.lib.readings import decode_roofline


def read(record):
    return decode_roofline(record, record.get("serve"))
