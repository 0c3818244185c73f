"""The operations of the window's prefills (the configuration's products
for the computed tokens, their causal attention, the last position's
logits; ``counts.prefill_flops``) over the host time inside
``ServingEngine.prefill`` at the bf16 peak (989 TFLOP/s), in %."""
from perfbench.lib import counts


def read(record):
    s = record.get("serve")
    calls = [c for c in (s or {}).get("prefill_calls", ())
             if s["t0_ns"] <= c[0] and c[1] <= s["end_ns"]]
    if not calls:
        return None
    flops = sum(counts.prefill_flops(record["cfg"], T, pre)
                for _, _, T, pre in calls)
    secs = sum(b - a for a, b, *_ in calls) / 1e9
    return 100.0 * flops / (secs * counts.PEAK_FLOPS_BF16)
