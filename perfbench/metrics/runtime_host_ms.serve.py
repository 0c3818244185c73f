"""Host milliseconds a request spends inside ``DisaggServer.serve`` outside
the engine's calls (prefill, decode step): the orchestrator, the modeled
network and the policy, the paged store's puts and gathers, the
hand-over to the decode batch. Over the serve calls that ended in the
window."""


def read(record):
    s = record.get("serve")
    if not s or not s["calls"]:
        return None
    inner = 0
    for c0, c1, _ in s["calls"]:
        inner += sum(b - a for a, b, *_ in s["prefill_calls"]
                     if c0 <= a and b <= c1)
        inner += sum(b - a for a, b, *_ in s["step_calls"]
                     if c0 <= a and b <= c1)
    outer = sum(c1 - c0 for c0, c1, _ in s["calls"])
    return (outer - inner) / 1e6 / sum(n for *_, n in s["calls"])
