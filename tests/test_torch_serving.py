"""The port's serving substrate held against the JAX one: paged KV store
and prefix index (same match lengths on the same token streams), greedy
``DecodeBatch`` tokens, and both ``DisaggServer``s on the same requests with
every ``ServeResult`` field equal (TTFT, deadline and SLO come from the same
analytic clock)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SMOKES as JSMOKES
from repro.launch.serve import make_requests as jmake_requests
from repro.models.lm import build_model as jbuild
from repro.serving import DecodeBatch as JDecodeBatch
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import DisaggServer as JDisaggServer
from repro.serving import PagedStore as JPagedStore
from repro.serving import PrefixIndex as JPrefixIndex
from repro.serving import ServeRequest as JServeRequest
from repro.serving import ServingEngine as JServingEngine
from repro.simcluster.hw import A100 as JA100
from repro_torch.configs import SMOKES
from repro_torch.core import make_policy
from repro_torch.core.stages import ChunkSpec
from repro_torch.launch.serve import make_requests, run
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (DecodeBatch, DisaggConfig, DisaggServer,
                                 PagedStore, PrefixIndex, ServeRequest,
                                 ServingEngine, cache_has_state)
from repro_torch.serving.paged_kv import tree_leaves_with_path
from repro_torch.simcluster.hw import A100, H100


@pytest.fixture(scope="module")
def smollm():
    """The same float32 weights in both packages."""
    jm = dataclasses.replace(jbuild(JSMOKES["smollm-360m"]),
                             dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKES["smollm-360m"], device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return tm.cfg, tm, jm, params


def _prefill(model, n, seed):
    toks = np.random.default_rng(seed).integers(0, model.cfg.vocab,
                                                size=(n,))
    _, cache = model.prefill({"tokens": toks[None]})
    return toks, cache


def _leaves(tree):
    return [x for _, x in tree_leaves_with_path(tree)]


# ------------------------------------------------------------------ paged KV
def test_paged_roundtrip(smollm):
    _, tm, _, _ = smollm
    _, cache = _prefill(tm, 24, 0)
    store = PagedStore(page_size=8, n_pages=32)
    pages = store.put(cache, 24)
    assert len(pages) == 3
    for a, b in zip(_leaves(cache), _leaves(store.gather(pages, 24))):
        assert torch.equal(a, b)


def test_paged_refcounting(smollm):
    _, tm, _, _ = smollm
    store = PagedStore(page_size=8, n_pages=8)
    _, cache = _prefill(tm, 16, 1)
    pages = store.put(cache, 16)
    free0 = store.alloc.n_free
    store.retain(pages)
    store.release(pages)
    assert store.alloc.n_free == free0         # still held by first ref
    store.release(pages)
    assert store.alloc.n_free == free0 + len(pages)
    with pytest.raises(MemoryError):
        store.put(cache, 16 * 8)


def test_prefix_index_page_aligned_match(smollm):
    cfg, tm, _, _ = smollm
    rng = np.random.default_rng(2)
    store = PagedStore(page_size=8, n_pages=64)
    index = PrefixIndex(store)
    base, cache = _prefill(tm, 24, 2)
    pages = store.put(cache, 24)
    index.insert_paged(base, pages, owner_unit=0, per_token_bytes=100.0)
    query = np.concatenate([base, rng.integers(0, cfg.vocab, size=(10,))])
    e = index.match(query)
    assert e is not None and e.n_tokens == 24
    query2 = base.copy()
    query2[9] = (query2[9] + 1) % cfg.vocab
    e2 = index.match(query2)
    assert e2 is not None and e2.n_tokens == 8
    assert index.match(rng.integers(0, cfg.vocab, size=(24,))) is None


def test_snapshot_regime_for_state_caches():
    cache = [[{"mix": {"state": torch.arange(6.0).reshape(1, 1, 6)}}]]
    assert cache_has_state(cache)
    index = PrefixIndex(PagedStore(page_size=8, n_pages=8))
    toks = np.arange(20)
    index.insert_snapshot(toks, cache, owner_unit=1)
    e = index.match(np.concatenate([toks, [7, 7]]))
    assert e is not None and e.n_tokens == 20 and e.owner_unit == 1
    assert index.fetch(e) is cache and e.bytes == 6 * 4
    with pytest.raises(ValueError):
        PagedStore().put(cache, 1)


def test_gather_slice_stitches_to_full_gather(smollm):
    _, tm, _, _ = smollm
    _, cache = _prefill(tm, 29, 3)
    store = PagedStore(page_size=8, n_pages=32)
    pages = store.put(cache, 29)
    full = store.gather(pages, 29)
    for bounds in ([0, 13, 29], [0, 8, 16, 29], [0, 29]):
        slices = [store.gather_slice(pages, a, b)
                  for a, b in zip(bounds, bounds[1:])]
        for i, want in enumerate(_leaves(full)):
            got = torch.cat([_leaves(s)[i] for s in slices], 2)
            assert torch.equal(got, want)
    with pytest.raises(ValueError):
        store.gather_slice(pages, 5, 5)


def test_prefix_index_match_lengths_equal_jax(smollm):
    """The same insertions and queries give the same match lengths in both
    indexes (same sha256 chain over the same int32 bytes)."""
    cfg, tm, jm, params = smollm
    rng = np.random.default_rng(4)
    tstore, jstore = PagedStore(8, 64), JPagedStore(8, 64)
    tidx, jidx = PrefixIndex(tstore), JPrefixIndex(jstore)
    shared = rng.integers(0, cfg.vocab, size=(20,))
    streams = [np.concatenate([shared, rng.integers(0, cfg.vocab, size=(n,))])
               for n in (4, 13, 30)] + [rng.integers(0, cfg.vocab, size=(17,))]
    for toks in streams[:2]:
        _, tc = tm.prefill({"tokens": toks[None]})
        _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[None],
                                                          jnp.int32)})
        tidx.insert_paged(toks, tstore.put(tc, len(toks)), 0, 1.0)
        jidx.insert_paged(toks, jstore.put(jc, len(toks)), 0, 1.0)
    for toks in streams + [shared, shared[:7], streams[1][:33]]:
        te, je = tidx.match(toks), jidx.match(toks)
        assert (te and te.n_tokens) == (je and je.n_tokens)
    assert len(tidx) == len(jidx)


# ------------------------------------------------------- continuous batching
def test_decode_batch_greedy_tokens_equal_jax(smollm):
    cfg, tm, jm, params = smollm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)) for n in (12, 19, 7)]
    teng, jeng = ServingEngine(tm), JServingEngine(jm, params)
    tdb = DecodeBatch(tm, capacity=32, max_slots=4)
    jdb = JDecodeBatch(jm, params, capacity=32, max_slots=4)
    got, want = {}, {}
    for rid, p in enumerate(prompts):
        t0, tc, _ = teng.prefill(p)
        j0, jc, _ = jeng.prefill(p)
        assert t0 == j0
        tdb.add(rid, tc, len(p), t0, max_new=3 + rid)
        jdb.add(rid, jc, len(p), j0, max_new=3 + rid)
        got[rid], want[rid] = [t0], [j0]
    while jdb.n_active:
        for rid, t in tdb.step().items():
            got[rid].append(t)
        for rid, t in jdb.step().items():
            want[rid].append(t)
    assert not tdb.n_active and got == want


def test_decode_batch_slot_recycling(smollm):
    cfg, tm, _, _ = smollm
    eng = ServingEngine(tm)
    db = DecodeBatch(tm, capacity=32, max_slots=2)
    rng = np.random.default_rng(6)
    for rid in range(4):                       # 4 requests through 2 slots
        p = rng.integers(0, cfg.vocab, size=(8 + rid,))
        t, c, _ = eng.prefill(p)
        db.add(rid, c, len(p), t, max_new=2)
        while db.n_active == db.max_slots:
            db.step()
    while db.n_active:
        db.step()
    assert len(db._free) == db.max_slots


def test_decode_batch_retires_at_capacity(smollm):
    cfg, tm, _, _ = smollm
    db = DecodeBatch(tm, capacity=12, max_slots=2)
    p = np.arange(9) % cfg.vocab
    t, c, _ = ServingEngine(tm).prefill(p)
    db.add(0, c, len(p), t, max_new=100)
    steps = 0
    while db.n_active:
        db.step()
        steps += 1
    assert steps == 12 - 1 - 9            # retired at pos == capacity - 1


# ------------------------------------------------------------- orchestrator
def _requests(cfg, req_cls):
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, size=(32,))
    reqs = []
    for i in range(6):
        if i % 2 == 0:
            toks = np.concatenate(
                [shared, rng.integers(0, cfg.vocab, size=(10,))])
        else:
            toks = rng.integers(0, cfg.vocab, size=(40,))
        reqs.append(req_cls(rid=i, arrival=i * 1e-4, tokens=toks, max_new=3))
    return reqs


def test_disagg_server_results_equal_jax(smollm):
    cfg, tm, jm, params = smollm
    srv = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=2, n_pages=128,
                                            hw=A100))
    jsrv = JDisaggServer(jm, params, cfg=JDisaggConfig(
        n_prefill_units=2, n_pages=128, hw=JA100))
    got = srv.serve(_requests(cfg, ServeRequest))
    want = jsrv.serve(_requests(cfg, JServeRequest))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert any(r.reused_tokens >= 32 for r in got)
    assert all(0 <= t < cfg.vocab for r in got for t in r.tokens)


def test_disagg_reuse_is_exact(smollm):
    """A request served via Stage-1 reuse produces the same first token as
    the identical request served cold."""
    cfg, tm, _, _ = smollm
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab, size=(32,))
    toks = np.concatenate([shared, rng.integers(0, cfg.vocab, size=(8,))])
    cold = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=1, n_pages=64))
    r_cold = cold.serve([ServeRequest(0, 0.0, toks, max_new=1)])[0]
    warm = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=1, n_pages=64))
    warm.serve([ServeRequest(0, 0.0, np.concatenate(
        [shared, rng.integers(0, cfg.vocab, size=(6,))]), max_new=1)])
    r_warm = warm.serve([ServeRequest(1, 1.0, toks, max_new=1)])[0]
    assert r_warm.reused_tokens >= 32
    assert r_warm.first_token == r_cold.first_token


def test_chunked_disagg_reuse_is_exact(smollm):
    cfg, tm, _, _ = smollm
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab, size=(24,))
    full = np.concatenate([prefix, rng.integers(0, cfg.vocab, size=(9,))])
    base = dict(n_prefill_units=1, layer_groups=2, hw=A100, n_pages=64,
                page_size=8)
    want = DisaggServer(tm, cfg=DisaggConfig(**base)).serve(
        [ServeRequest(rid=0, arrival=0.0, tokens=full, max_new=1)])[0]
    srv = DisaggServer(tm, cfg=DisaggConfig(
        **base, chunk=ChunkSpec(chunk_tokens=8)))
    res = srv.serve([ServeRequest(rid=0, arrival=0.0, tokens=prefix,
                                  max_new=1),
                     ServeRequest(rid=1, arrival=0.05, tokens=full,
                                  max_new=1)])
    assert res[1].reused_tokens == 24
    assert res[1].first_token == want.first_token


@pytest.mark.parametrize("pol", ["mfs", "fs", "sjf", "edf", "karuna"])
def test_disagg_policies_all_run(smollm, pol):
    cfg, tm, _, _ = smollm
    rng = np.random.default_rng(8)
    reqs = [ServeRequest(i, i * 1e-4, rng.integers(0, cfg.vocab, size=(24,)),
                         max_new=1) for i in range(4)]
    srv = DisaggServer(tm, policy=make_policy(pol),
                       cfg=DisaggConfig(n_prefill_units=2))
    assert len(srv.serve(reqs)) == 4


def test_default_hw_is_h100():
    assert DisaggConfig().hw is H100
    assert (H100.flops, H100.hbm_bw, H100.scaleup_bw) == (989e12, 3.35e12,
                                                          900e9)
    assert H100.nic_bw == 400e9 / 8


def test_launcher_runs_on_cpu_when_asked():
    summary = run("smollm-360m", device="cpu", n_requests=6,
                  policies=("mfs", "fs"), verbose=False)
    assert sorted(summary) == ["fs", "mfs"]
    for s in summary.values():
        assert 0.0 <= s["slo_attainment"] <= 1.0
        assert s["mean_ttft_ms"] > 0.0 and 0.0 <= s["reuse_fraction"] < 1.0


def test_make_requests_equal_jax():
    cfg = SMOKES["smollm-360m"]
    got = make_requests(cfg, 12, 200.0, seed=3, mean_prompt=64, max_new=5)
    want = jmake_requests(JSMOKES["smollm-360m"], 12, 200.0, seed=3,
                          mean_prompt=64, max_new=5)
    for a, b in zip(got, want):
        assert (a.rid, a.arrival, a.max_new) == (b.rid, b.arrival, b.max_new)
        np.testing.assert_array_equal(a.tokens, b.tokens)
