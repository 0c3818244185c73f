"""Share of the requests due in the window whose modeled TTFT met its
deadline on the modeled cluster (``ServeResult.met_slo``; a shed request
misses). The seed fixes the set and the modeled clock, not how far the
card got."""


def read(record):
    s = record.get("serve")
    if not s or not s["met_slo"]:
        return None
    return 100.0 * sum(s["met_slo"]) / len(s["met_slo"])
