"""The port's wall-clock spans and counters (``repro_torch.tracing``) and the
benchmark's readers of them.

On the CPU (float32, a tiny dense model): a decode step records nothing
while the recorder is off; inside ``recording()`` and inside a CPU
``torch.profiler`` session it records the step's span tree, a ``host_syncs``
bump for each of its three copies that crosses to or from a CUDA device
(none on the CPU) and each admission's ``rid``, within the recorder's
bound; a new profiler session starts it empty. Each reader of
``perfbench/metrics/`` gives its number on a hand-built window, and nothing
where the program has no recorder. On the card (marker ``cuda``), where
the batch replays a CUDA graph of its step: the program's spans and the
device trace share one clock; ``host_syncs`` counts every synchronize that
``torch.cuda.set_sync_debug_mode`` sees in whole steps, the capturing one
among them, and the model's dispatch makes none, on a toy model and on
the decode cell's minitron-8b cut to two layers. Neither imports ``jax``
nor the JAX package.
"""
import contextlib
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.serving import DecodeBatch, ServingEngine
from repro_torch.serving import engine as engine_mod
from repro_torch.tracing import REC, recording, syncs

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import program, spec, traffic, weights  # noqa: E402
from perfbench.lib.trace import DeviceTrace  # noqa: E402

STEP_CHILDREN = ["engine.inputs", "model.decode_step", "engine.sync",
                 "engine.retire"]


@pytest.fixture
def rec():
    REC.clear()
    yield REC
    REC.clear()


def _batch(cfg, device, dtype, slots=3, capacity=64, max_new=50, seed=0):
    torch.manual_seed(seed)
    model = build_model(cfg, device=device, dtype=dtype)
    eng = ServingEngine(model)
    db = DecodeBatch(model, capacity=capacity, max_slots=slots)
    rng = np.random.default_rng(seed)
    for rid in range(slots):
        p = rng.integers(0, cfg.vocab, size=(8 + 3 * rid,))
        first, cache, _ = eng.prefill(p)
        db.add(100 + rid, cache, len(p), first, max_new=max_new)
    return model, eng, db


@pytest.fixture
def tiny():
    cfg = SMOKES["minitron-8b"]
    return cfg, _batch(cfg, "cpu", torch.float32, slots=2)


@contextlib.contextmanager
def _session(how):
    if how == "recording":
        with recording():
            yield
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            yield


def test_off_records_nothing(tiny, rec):
    _, (_, _, db) = tiny
    db.step()
    assert rec.rows == [] and rec.bumps == [] and rec.dropped == 0


def _one_step(tiny, how, steps=1):
    """Steps, then one admission (rid 7) into a freed slot, inside a
    session; the spans and the step's number before."""
    cfg, (model, eng, db) = tiny
    n0 = db.n_steps
    first, cache, _ = eng.prefill(np.arange(9) % cfg.vocab)
    with _session(how):
        for _ in range(steps):
            db.step()
        db.remove(next(iter(db.slots)))
        db.add(7, cache, 9, first, max_new=50)
    return REC.spans(), n0


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_step_span_tree(tiny, rec, how):
    spans, n0 = _one_step(tiny, how)
    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == 1 and steps[0].id == n0 + 1
    assert steps[0].parent == -1
    kids = [s for s in spans if s.parent == steps[0].index]
    assert [s.name for s in kids] == STEP_CHILDREN
    for a, b in zip(kids, kids[1:]):
        assert a.t1_ns <= b.t0_ns
    assert all(steps[0].t0_ns <= s.t0_ns and s.t1_ns <= steps[0].t1_ns
               for s in kids)


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_layer_spans_inside_the_dispatch(tiny, rec, how):
    cfg, _ = tiny
    spans, _ = _one_step(tiny, how)
    (top,) = [s for s in spans if s.name == "model.decode_step"]
    layers = [s for s in spans if s.name == "model.layer"]
    assert [s.id for s in layers] == list(range(cfg.n_layers))
    for s in layers:
        assert s.parent == top.index
        assert top.t0_ns <= s.t0_ns <= s.t1_ns <= top.t1_ns
    # the CPU runs the plain attention: no kernel span
    assert not [s for s in spans if s.name == "kernel.decode_attention"]


@pytest.mark.parametrize("how", ["recording", "profiler"])
@pytest.mark.parametrize("crossing", [False, True])
def test_host_syncs_a_step(tiny, rec, how, crossing, monkeypatch):
    """Each of a step's three copies (two inputs in, the tokens out) bumps
    ``host_syncs`` by what ``syncs`` says of it: none on the CPU, three
    where every copy crosses to or from a card."""
    if crossing:
        monkeypatch.setattr(engine_mod, "syncs", lambda src, dst: 1)
    _one_step(tiny, how, steps=3)
    per_step = 3 if crossing else 0
    assert rec.counted("host_syncs") == 3 * per_step
    steps = [s for s in rec.spans() if s.name == "engine.step"]
    assert len(steps) == 3
    assert all(rec.counted("host_syncs", s.t0_ns, s.t1_ns) == per_step
               for s in steps)


def _on(device):
    return SimpleNamespace(device=torch.device(device))


@pytest.mark.parametrize("src, dst, n", [
    ("cpu", "cpu", 0), ("cpu", "cuda", 1), ("cuda", "cpu", 1),
    ("cuda", "cuda", 0), ("cuda:0", "cuda:1", 0), ("cpu", "meta", 0)])
def test_syncs_counts_a_crossing(src, dst, n):
    assert syncs(_on(src), _on(dst)) == n


@pytest.mark.parametrize("inside_recording", [False, True])
def test_a_new_profiler_session_starts_empty(tiny, rec, inside_recording):
    """A profile taken earlier in the process, then steps untraced (the
    benchmark's warm-up), leave nothing to crowd out the next session's
    spans; inside ``recording()`` nothing is dropped."""
    _, (_, _, db) = tiny
    outer = recording() if inside_recording else contextlib.nullcontext()
    with outer:
        with _session("profiler"):
            db.step()
        before = len(rec.rows)
        if not inside_recording:
            db.step()
            assert len(rec.rows) == before
        with _session("profiler"):
            db.step()
    steps = [s for s in rec.spans() if s.name == "engine.step"]
    assert before > 0
    assert len(steps) == (2 if inside_recording else 1)
    assert len(rec.rows) == (2 * before if inside_recording else before)


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_add_carries_its_rid(tiny, rec, how):
    spans, _ = _one_step(tiny, how)
    adds = [s for s in spans if s.name == "engine.add"]
    assert [(s.id, s.parent) for s in adds] == [(7, -1)]


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_bound_drops_and_counts(tiny, rec, how, monkeypatch):
    cfg, _ = tiny
    monkeypatch.setattr(rec, "limit", 5)
    _one_step(tiny, how)
    # a step opens 5 + n_layers spans and the add one more; 2 bumps
    assert len(rec.rows) == 5
    assert rec.dropped == 5 + cfg.n_layers + 1 - 5
    assert [r[0] for r in rec.rows] == ["engine.step"] + STEP_CHILDREN[:2] \
        + ["model.layer"] * 2
    assert all(r[2] >= r[1] > 0 for r in rec.rows)     # every kept one ends
    assert len(rec.bumps) == 2


# --------------------------------------------------------------- readers
#: a hand-built window [0, 1000] ns: two steps, an add between them, and a
#: step and bumps past the window's end (left out)
ROWS = [
    ["engine.step", 100, 200, -1, 1],            # 0
    ["engine.inputs", 100, 110, 0, None],
    ["model.decode_step", 110, 180, 0, None],    # 2
    ["model.layer", 115, 140, 2, 0],
    ["kernel.decode_attention", 120, 125, 3, None],
    ["model.layer", 140, 175, 2, 1],
    ["kernel.decode_attention", 145, 152, 5, None],
    ["engine.sync", 180, 195, 0, None],
    ["engine.retire", 195, 199, 0, None],
    ["engine.add", 250, 260, -1, 9],
    ["engine.step", 300, 420, -1, 2],            # 10
    ["engine.inputs", 300, 305, 10, None],
    ["model.decode_step", 305, 400, 10, None],   # 12
    ["model.layer", 310, 350, 12, 0],
    ["kernel.decode_attention", 312, 321, 13, None],
    ["model.layer", 350, 398, 12, 1],
    ["kernel.decode_attention", 352, 356, 15, None],
    ["engine.sync", 400, 415, 10, None],
    ["engine.retire", 415, 418, 10, None],
    ["engine.step", 2000, 2100, -1, 3],
    ["model.decode_step", 2010, 2090, 19, None],
]
BUMPS = [(105, "host_syncs", 2), (190, "host_syncs", 1),
         (302, "host_syncs", 2), (399, "decode_graph_replays", 1),
         (410, "host_syncs", 1), (2050, "host_syncs", 3),
         (2060, "decode_graph_replays", 1)]
#: (name, start, duration): the trace's marker, three ops in step 1, one in
#: the add, two in step 2
OPS = [("marker", 0, 1), ("a", 112, 10), ("b", 130, 5), ("c", 185, 2),
       ("d", 255, 3), ("e", 310, 10), ("f", 350, 10)]

READINGS = {
    "decode_dispatch_ms": (70 + 95) / 2 / 1e6,
    "decode_attention_host_ms": (5 + 7 + 9 + 4) / 2 / 1e6,
    "decode_host_wait_pct": 100.0 * (15 + 15) / (100 + 120),
    "decode_engine_self_ms": ((100 + 120) - (70 + 95) - (15 + 15)) / 2 / 1e6,
    "decode_host_syncs_per_step": 3.0,
    "decode_graph_share": 100.0 * 1 / 2,
    "decode_ops_per_step": 5 / 2,
    # idle gaps [122, 130], [135, 185] and [320, 350] have their middles
    # inside a model.decode_step: 88 ns of the 1000
    "device_idle_dispatch.decode": 8.8,
}


def _record():
    tr = DeviceTrace()
    tr.t0_ns, tr.t1_ns, tr.ops = 0, 1000, list(OPS)
    return {"trace": tr, "decode": {"step_calls": []}}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_on_a_hand_built_window(rec, metric):
    rec.rows = [list(r) for r in ROWS]
    rec.bumps = list(BUMPS)
    got = spec.reader(metric).read(_record())
    assert got == pytest.approx(READINGS[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_reads_nothing_without_a_recorder(rec, metric, monkeypatch):
    """As on a program that lacks ``repro_torch.tracing``, and on a run
    without a trace."""
    rec.rows = [list(r) for r in ROWS]
    rec.bumps = list(BUMPS)
    read = spec.reader(metric).read
    assert read({"trace": None, "decode": {}}) is None
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(_record()) is None


def test_graph_share_reads_nothing_without_a_graph_path(rec, monkeypatch):
    """As on a program whose ``DecodeBatch`` cannot replay a graph."""
    rec.rows = [list(r) for r in ROWS]
    rec.bumps = list(BUMPS)
    read = spec.reader("decode_graph_share").read
    assert read(_record()) == 50.0
    monkeypatch.delattr(engine_mod, "graphable")
    assert read(_record()) is None


#: the readings that also read the MLA and expert cell's record (its
#: steps replay a graph; dispatch and the attention wrapper are dense-only)
ALSO_MLA_MOE = {"decode_host_syncs_per_step", "decode_graph_share"}


def test_every_new_metric_is_in_the_benchmark():
    names = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for metric in READINGS:
        cells = ["minitron-8b.decode-64"]
        if metric in ALSO_MLA_MOE:
            cells.append("deepseek-v3.decode-reason-128")
        assert names[metric]["workloads"] == cells
        assert names[metric]["moves"] == "tpot_p95_ms"


# ------------------------------------------------------------------- card
#: how far (ns) a device operation may lie outside the ``engine.step``
#: span that launched it, on the device trace's clock anchored on a probe
#: launched at a known host time: the probe's launch latency
CLOCK_TOL_NS = 50_000
#: how far (ns) ``DeviceTrace``'s own mapping of the device clock may lie
#: from the probe's: the marker's launch latency less the probe's, 65-187
#: us seen on the H100
LAG_TOL_NS = 250_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the decode attention kernel "
                    "has no CPU mode")
    return "cuda"


CARD_CFG = ArchConfig(name="trace-card", family="dense", n_layers=4,
                      d_model=512, n_heads=8, n_kv=2, d_ff=1024, vocab=1024,
                      head_dim=64, source="test")


@pytest.mark.cuda
def test_spans_and_device_trace_share_a_clock(card, rec):
    _, _, db = _batch(CARD_CFG, card, torch.bfloat16, slots=4,
                      capacity=256, max_new=200)
    for _ in range(3):
        db.step()
    probe = torch.zeros(1, device=card)
    rec.clear()
    with DeviceTrace() as tr:
        for _ in range(8):
            db.step()
        # DeviceTrace puts its marker's device start at the host time before
        # the marker's launch, so every operation lands earlier than it ran
        # by the marker's launch latency (the session's first launch, an
        # allocation among it: 65-187 us seen on the H100). A probe, one
        # kernel into memory already held, launched after a synchronize
        # measures that shift. The mapping is held to LAG_TOL_NS, each
        # operation to its step within that shift and CLOCK_TOL_NS, and
        # within CLOCK_TOL_NS on the clock the probe anchors, where the
        # step's first copy, which starts at once, lies inside its span
        torch.cuda.synchronize()
        t_probe = time.perf_counter_ns()
        probe.fill_(1.0)
    lag = t_probe - tr.ops[-1][1]
    spans = rec.spans(tr.t0_ns, tr.t1_ns)
    steps = sorted((s.t0_ns, s.t1_ns) for s in spans
                   if s.name == "engine.step")
    assert len(steps) == 8
    # each step replays the graph inside its model.decode_step span: no
    # layer or kernel wrapper runs on the host
    replays = [s for s in spans if s.name == "model.decode_step"]
    by_index = {s.index: s for s in spans}
    assert len(replays) == 8
    assert all(by_index[r.parent].name == "engine.step" for r in replays)
    assert not [s for s in spans if s.name in ("model.layer",
                                               "kernel.decode_attention")]
    assert rec.counted("decode_graph_replays", tr.t0_ns, tr.t1_ns) == 8
    assert rec.counted("host_syncs", tr.t0_ns, tr.t1_ns) == 8
    def outside(start, dur):
        return min(max(a - start, start + dur - b, 0) for a, b in steps)
    raw = worst = 0
    for _, start, dur in tr.ops[1:-1]:    # the marker and the probe
        raw = max(raw, outside(start, dur))
        worst = max(worst, outside(start + lag, dur))
    print(f"DeviceTrace's mapping lags by {lag} ns; device ops outside "
          f"their step: at most {raw} ns on its mapping, {worst} ns on the "
          f"probe's")
    assert abs(lag) <= LAG_TOL_NS
    assert raw <= abs(lag) + CLOCK_TOL_NS
    assert worst <= CLOCK_TOL_NS


def _cell_batch(device, layers=2, seed=2147483659):
    """The decode cell's batch (``minitron-8b.decode-64``: published widths,
    64 slots over caches of ~1-3k tokens, weights from the seed), its
    model cut to ``layers``."""
    bench = spec.benchmark()
    name = "minitron-8b.decode-64"
    w = spec.workload(bench, name)
    cfg = dict(spec.config(bench, w["config"]), num_hidden_layers=layers)
    P = spec.cell_params(name)
    model = program.build(cfg, weights.make(cfg, seed, device), device)
    eng = ServingEngine(model)
    db = DecodeBatch(model, capacity=P["capacity"], max_slots=P["slots"])
    pool = traffic.decode_pool(spec.traffic(w["traffic"]), seed,
                               cfg["vocab_size"], P["capacity"])
    for rid, s in enumerate(pool[:P["slots"]]):
        first, cache, _ = eng.prefill(s.tokens)
        db.add(rid, cache, len(s.tokens), first, max_new=s.max_new)
    return model, eng, db


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["toy", "cell"])
def test_dispatch_makes_no_host_sync(card, rec, size):
    if size == "toy":
        model, _, db = _batch(CARD_CFG, card, torch.bfloat16, slots=4,
                              capacity=256, max_new=200)
    else:
        model, _, db = _cell_batch(card)
    # every synchronize the detector sees in whole steps, host_syncs counts:
    # the first step, which captures the graph, and three replays
    torch.cuda.synchronize()
    rec.clear()
    with warnings.catch_warnings(record=True) as seen, recording():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(4):
                db.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the detector's own message; its first use in a process also warns
    # once that it is a prototype, which is no synchronize
    synced = [w for w in seen
              if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"{size}: {len(synced)} synchronizes seen in 4 steps, "
          f"host_syncs {rec.counted('host_syncs')}; warnings: "
          f"{sorted({str(w.message)[:72] for w in seen})}")
    assert db._graph is not None
    assert rec.counted("decode_graph_replays") == 3
    assert len(synced) == rec.counted("host_syncs") == 4
    rec.clear()
    tok = torch.from_numpy(db._tok[:, None]).to(card)
    pos = torch.from_numpy(db._pos).to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with recording():
            logits, db._stacked = model.decode_step(db._stacked, tok, pos)
        # what host_syncs counts, the detector sees
        with pytest.raises(RuntimeError):
            torch.from_numpy(db._pos).to(card)
        with pytest.raises(RuntimeError):
            logits.argmax(-1).cpu()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [s.name for s in rec.spans() if s.parent == -1] \
        == ["model.decode_step"]
