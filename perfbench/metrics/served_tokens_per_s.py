"""Tokens served a second over the window: the prompt of every request
whose first token reached the host in the window, and every output token
that did, over the window's length."""


def read(record):
    s = record.get("serve")
    if not s:
        return None
    return s["served_tokens"] / ((s["end_ns"] - s["t0_ns"]) / 1e9)
