"""Share of the traced window's decode steps that replayed the captured
CUDA graph of the model's step: the program's counter
``decode_graph_replays`` over its ``engine.step`` spans, in %. A program
whose ``DecodeBatch`` has no graph path (no ``graphable`` in
``repro_torch.serving.engine``) gives no reading."""
from perfbench.lib.spans import decode_window

REPLAYS = "decode_graph_replays"


def read(record):
    w = decode_window(record)
    if w is None:
        return None
    from repro_torch.serving import engine
    from repro_torch.tracing import REC
    if not hasattr(engine, "graphable"):
        return None
    tr = record["trace"]
    return 100.0 * REC.counted(REPLAYS, tr.t0_ns, tr.t1_ns) / len(w.steps)
