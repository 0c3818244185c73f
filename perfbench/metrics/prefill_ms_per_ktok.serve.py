"""Host milliseconds inside ``ServingEngine.prefill`` for each 1000 prompt
tokens it computed (a reused prefix is not computed), over the window."""


def read(record):
    s = record.get("serve")
    calls = [c for c in (s or {}).get("prefill_calls", ())
             if s["t0_ns"] <= c[0] and c[1] <= s["end_ns"]]
    if not calls:
        return None
    return sum(b - a for a, b, *_ in calls) / 1e6 / (
        sum(c[2] for c in calls) / 1000.0)
