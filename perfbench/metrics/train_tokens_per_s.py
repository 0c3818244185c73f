"""Tokens of every training step of the window over the time from the
window's start to the end of its last step."""


def read(record):
    t = record.get("train")
    if not t or t["elapsed_s"] <= 0:
        return None
    return t["tokens"] / t["elapsed_s"]
