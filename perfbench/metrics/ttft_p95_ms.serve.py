"""95th percentile over every request due in the window of the time from
its due time to the host holding its first token; a request not served
by the window's end enters at (end - due). Above the rate the server
sustains, this swings with the growing queue."""
from perfbench.lib.stats import percentile


def read(record):
    s = record.get("serve")
    if not s or not s["ttft_s"]:
        return None
    return percentile(s["ttft_s"], 95) * 1e3
