"""Share of the prompt tokens of the requests served in the window that
came from a reused prefix (``ServeResult.reused_tokens``)."""


def read(record):
    s = record.get("serve")
    if not s or not s["prompt_tokens"]:
        return None
    return 100.0 * s["reused"] / s["prompt_tokens"]
