"""``DecodeBatch``'s CUDA graph of the decode step (``serving.engine``).

On the CPU: the graph engages on what the code can observe (``graphable``:
a CUDA model on one rank), and nowhere else: on the CPU, on the meta device
and under a mesh of more than one rank the step runs ``Model.decode_step``
eagerly, replays nothing and records the spans and counters it always did.

On the card (marker ``cuda``): over 45 steps, with slots retiring and
refilled by ``add``, a graphed ``DecodeBatch`` serves the tokens, the
logits and the caches of an eager loop that calls ``Model.decode_step``
directly on a copy of the same caches, bitwise: the decode cell's
minitron-8b cut to two layers, and a toy of each family that runs on one
card (dense GQA, int8 K/V, MoE, SSM, RG-LRU, MLA, encoder-decoder). One
capture a batch; ``decode_graph_replays`` counts every later step.
Neither imports ``jax`` nor the JAX package.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.models.blocks import _kv_store
from repro_torch.serving import DecodeBatch, ServingEngine
from repro_torch.serving.engine import graphable
from repro_torch.serving.paged_kv import (tree_leaves_with_path,
                                          tree_map_with_path)
from repro_torch.tracing import REC, recording

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import program, spec, traffic, weights  # noqa: E402

STEP_CHILDREN = ["engine.inputs", "model.decode_step", "engine.sync",
                 "engine.retire"]


@pytest.fixture
def rec():
    REC.clear()
    yield REC
    REC.clear()


def _mesh(*shape):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)))


def _stand_in(device, mesh=None, vocab=8):
    """A model as ``DecodeBatch`` sees one: its device, its mesh, and a
    decode step that checks where its inputs are and puts token 3 first."""
    calls = []

    def decode_step(caches, tok, pos):
        assert tok.device == pos.device == torch.device(device)
        calls.append((tuple(tok.shape), tuple(pos.shape)))
        logits = torch.zeros(tok.shape[0], 1, vocab)
        logits[..., 3] = 1.0
        return logits, caches
    return SimpleNamespace(device=torch.device(device),
                           ctx=SimpleNamespace(mesh=mesh),
                           decode_step=decode_step, calls=calls)


@pytest.mark.parametrize("device, mesh, want", [
    ("cuda", None, True), ("cuda", _mesh(1, 1), True),
    ("cuda", _mesh(1, 2), False), ("cuda", _mesh(2, 1), False),
    ("cuda", _mesh(2, 2), False), ("cpu", None, False),
    ("meta", None, False), ("cpu", _mesh(1, 2), False)])
def test_graphable_on_what_the_code_observes(device, mesh, want):
    assert graphable(_stand_in(device, mesh)) is want


@pytest.mark.parametrize("device, mesh", [("cpu", None), ("meta", None),
                                          ("cpu", _mesh(2, 2))])
def test_stand_in_steps_eagerly(rec, device, mesh):
    """Off one CUDA rank every step calls the model's decode step, with
    the inputs on its device, and nothing is captured or replayed."""
    model = _stand_in(device, mesh)
    db = DecodeBatch(model, capacity=16, max_slots=3)
    assert not db.graphed
    cache = [[{"mix": {"state": torch.zeros(1, 1, 4)}}]]
    for rid in range(3):
        db.add(rid, cache, 5, first_token=1, max_new=4)
    with recording():
        for _ in range(4):
            assert set(db.step().values()) <= {3}
    assert model.calls == [((3, 1), (3,))] * 3
    assert db._graph is None
    assert rec.counted("decode_graph_replays") == 0
    steps = [s for s in rec.spans() if s.name == "engine.step"]
    assert len(steps) == 3                       # the fourth found no slot
    for st in steps:
        kids = [s.name for s in rec.spans() if s.parent == st.index]
        # the engine opens no model.decode_step span when it runs the
        # model eagerly: the model does, and this stand-in does not
        assert kids == [n for n in STEP_CHILDREN if n != "model.decode_step"]


def test_cpu_batch_steps_the_model_eagerly(rec):
    """A real model on the CPU: ``DecodeBatch.logits`` and its tokens are
    those of ``Model.decode_step`` called directly on a copy of the
    caches, with no capture and no replay."""
    cfg = SMOKES["minitron-8b"]
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    eng = ServingEngine(model)
    db = DecodeBatch(model, capacity=32, max_slots=2)
    rng = np.random.default_rng(0)
    for rid in range(2):
        p = rng.integers(0, cfg.vocab, size=(6 + 3 * rid,))
        first, cache, _ = eng.prefill(p)
        db.add(rid, cache, len(p), first, max_new=20)
    ref = tree_map_with_path(lambda _, t: t.clone(), db._stacked)
    for _ in range(3):
        tok = torch.from_numpy(db._tok.copy()[:, None])
        pos = torch.from_numpy(db._pos.copy())
        logits, ref = model.decode_step(ref, tok, pos)
        with recording():
            out = db.step()
        assert torch.equal(db.logits, logits[:, -1])
        want = logits[:, -1].argmax(-1)
        assert out == {m.rid: int(want[s]) for s, m in db.slots.items()}
    assert not db.graphed and db._graph is None
    assert rec.counted("decode_graph_replays") == 0
    assert len([s for s in rec.spans() if s.name == "model.layer"]) \
        == 3 * cfg.n_layers


# ------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the graph replays the "
                    "port's CUDA kernels, which have no CPU mode")
    return torch.device("cuda")


STEPS = 45

#: dense GQA toy: 8 query heads of 64 over 2 KV heads
GQA = ArchConfig(name="graph-gqa", family="dense", n_layers=2, d_model=256,
                 n_heads=8, n_kv=2, d_ff=512, vocab=512, head_dim=64,
                 source="test")


def _int8(model, cache, n):
    """A prefill's cache as an int8 decode cache holds it (``init_cache``'s
    real KV heads, codes of 1/32)."""
    out = model.init_cache(1, n, kv_dtype=torch.int8)

    def put(_, dst, src):
        dst.copy_(_kv_store(src[..., :dst.shape[-2], :], torch.int8))
        return dst
    return tree_map_with_path(put, out, cache)


def _toy_requests(cfg, device, kind, n_reqs=12):
    """A toy model of ``cfg`` in bf16 and its prefilled requests (prompt
    length, cache, first token, max_new): prompts of 5-20 tokens, outputs
    of 3-30, so that slots retire and refill within the steps."""
    torch.manual_seed(0)
    model = build_model(cfg, device=device, dtype=torch.bfloat16)
    eng = ServingEngine(model)
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(n_reqs):
        n = int(rng.integers(5, 21))
        extra = None
        if cfg.enc_layers:               # one source length a batch
            extra = {"src_embeds": rng.normal(
                size=(1, 8, cfg.d_model)).astype(np.float32)}
        first, cache, _ = eng.prefill(rng.integers(0, cfg.vocab, size=(n,)),
                                      extra=extra)
        if kind == "int8":
            cache = _int8(model, cache, n)
        reqs.append((n, cache, first, int(rng.integers(3, 31))))
    return model, reqs


def _cell_requests(device, seed=2147483659):
    """The decode cell's model (``minitron-8b.decode-64``: published
    widths, bf16, weights from the seed) cut to two layers, and its pool's
    requests, the first fill ramped as ``perfbench/drivers/decode.py``
    ramps it."""
    bench = spec.benchmark()
    name = "minitron-8b.decode-64"
    w = spec.workload(bench, name)
    cfg = dict(spec.config(bench, w["config"]), num_hidden_layers=2)
    P = spec.cell_params(name)
    model = program.build(cfg, weights.make(cfg, seed, device), device)
    eng = ServingEngine(model)
    pool = traffic.decode_pool(spec.traffic(w["traffic"]), seed,
                               cfg["vocab_size"], P["capacity"])
    reqs = []
    for k, s in enumerate(pool):
        first, cache, _ = eng.prefill(s.tokens)
        out = max(2, round(s.max_new * (k + 1) / P["slots"]))
        reqs.append((len(s.tokens), cache, first, out))
    return model, reqs, P["slots"], P["capacity"]


def _graph_against_eager(model, reqs, slots, capacity):
    """Steps a graphed ``DecodeBatch`` and, beside it, an eager loop of
    ``Model.decode_step`` over a copy of its caches, fed the tokens that
    loop chose; a slot that retires is refilled at once (``add``, its
    cache copied into the loop's). Asserts equal logits, tokens and
    caches; returns the slots retired."""
    dev = model.device
    db = DecodeBatch(model, capacity=capacity, max_slots=slots)
    assert db.graphed
    tok = np.zeros(slots, np.int64)
    pos = np.zeros(slots, np.int64)
    ref = {}
    taken = [0]

    def admit():
        k = taken[0]
        taken[0] += 1
        n, cache, first, max_new = reqs[k % len(reqs)]
        slot = db.add(k, cache, n, first, max_new=max_new)
        if ref:
            tree_map_with_path(
                lambda _, a, b: a[:, slot].copy_(b[:, slot]),
                ref["caches"], db._stacked)
        tok[slot], pos[slot] = first, n

    for _ in range(slots):
        admit()
    ref["caches"] = tree_map_with_path(lambda _, t: t.clone(), db._stacked)
    retired = 0
    with recording():
        for _ in range(STEPS):
            live = dict(db.slots)
            logits, ref["caches"] = model.decode_step(
                ref["caches"], torch.from_numpy(tok[:, None]).to(dev),
                torch.from_numpy(pos).to(dev))
            want = logits[:, -1]
            out = db.step()
            assert torch.equal(db.logits, want)
            chosen = want.argmax(-1).cpu().numpy()
            assert out == {m.rid: int(chosen[s]) for s, m in live.items()}
            for s in live:
                tok[s], pos[s] = chosen[s], pos[s] + 1
            retired += sum(s not in db.slots for s in live)
            while db.n_active < slots:
                admit()
            assert np.array_equal(tok, db._tok)
            assert np.array_equal(pos, db._pos)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(db._stacked),
                                tree_leaves_with_path(ref["caches"])):
        assert pa == pb and torch.equal(a, b)
    assert db._graph is not None
    assert REC.counted("decode_graph_replays") == STEPS - 1
    assert REC.counted("host_syncs") == STEPS        # the read of each step
    return retired


@pytest.mark.cuda
def test_cell_graph_equals_eager_loop(card, rec):
    model, reqs, slots, capacity = _cell_requests(card)
    retired = _graph_against_eager(model, reqs, slots, capacity)
    print(f"minitron-8b at 2 layers, {slots} slots x {capacity}: "
          f"{STEPS} steps, {retired} slots retired and refilled")
    assert retired > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind, cfg", [
    ("dense", GQA), ("int8", GQA), ("moe", SMOKES["deepseek-moe-16b"]),
    ("ssm", SMOKES["mamba2-1.3b"]), ("rglru", SMOKES["recurrentgemma-9b"]),
    ("mla", SMOKES["deepseek-v3-671b"]),
    ("encdec", SMOKES["seamless-m4t-medium"])],
    ids=["dense", "int8", "moe", "ssm", "rglru", "mla", "encdec"])
def test_toy_graph_equals_eager_loop(card, rec, kind, cfg):
    model, reqs = _toy_requests(cfg, card, kind)
    retired = _graph_against_eager(model, reqs, slots=4, capacity=64)
    print(f"{kind} ({cfg.name} toy): {STEPS} steps, {retired} slots "
          "retired and refilled")
    assert retired > 0
