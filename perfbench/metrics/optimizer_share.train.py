"""Device time of ``trainer.adamw_update`` (CUDA events recorded on the
stream before and after each call in the traced steps) over the device's
busy time in those steps, in %."""


def read(record):
    t, tr = record.get("train"), record.get("trace")
    if not t or tr is None or tr.busy_s <= 0 or not t["traced_steps"]:
        return None
    return 100.0 * t["optimizer_s"] / tr.busy_s
