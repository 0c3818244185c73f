"""The port's encoder-decoder (seamless-m4t-medium: an encoder of
bidirectional attention and SwiGLU layers over the stubbed speech
frontend's frame embeddings, and a decoder whose layers also attend to the
encoder's memory) held against the JAX package on the same numpy inputs
and the same float32 weights, converted from the JAX ``Model.init`` tree:
``_encode``, a prefill from ``src_embeds`` (logits, the decoder caches and
the cross K/V), a suffix prefill over a snapshot that holds cross K/V,
decode steps, ``init_cache(src_len=)``, greedy ``DecodeBatch`` tokens and
every ``ServeResult`` field of both ``DisaggServer``s on an agent stream
whose follow-ups resume snapshots and carry their sources in ``extra``."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SMOKES as JSMOKES
from repro.models.lm import build_model as jbuild
from repro.serving import DecodeBatch as JDecodeBatch
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import DisaggServer as JDisaggServer
from repro.serving import ServeRequest as JServeRequest
from repro.serving import ServingEngine as JServingEngine
from repro.simcluster.hw import A100 as JA100
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.launch.serve import agent_requests, run, src_len_for
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (DecodeBatch, DisaggConfig, DisaggServer,
                                 ServeRequest, ServingEngine, cache_has_state)
from repro_torch.simcluster.hw import A100

ROOT = Path(__file__).resolve().parent.parent
ARCH = "seamless-m4t-medium"
TOL = 2e-4          # float32 through the model, as tests/test_torch_dense.py
SRC = 8             # encoder frames, as tests/test_models.py


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    jm = dataclasses.replace(jbuild(JSMOKES[ARCH]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKES[ARCH], device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


def _caches_close(tc, jc):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        t = tc
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(t.shape) == leaf.shape and \
            str(t.dtype)[6:] == str(leaf.dtype), path
        _close(t, leaf)


def _src(cfg, B, seed, S=SRC):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, n))


def test_encode_matches_jax(pair):
    jm, params, tm = pair
    src = _src(tm.cfg, 2, 1)
    want = jm._encode(params, jnp.asarray(src))
    got = tm._encode(src)
    assert got.shape == want.shape == (2, SRC, tm.cfg.d_model)
    _close(got, want)


def test_prefill_with_src_embeds_matches_jax(pair):
    """Logits, the decoder's K/V and each layer's cross K/V [count, B,
    src_len, n_kv, hd] beside ``"mix"``."""
    jm, params, tm = pair
    src, toks = _src(tm.cfg, 2, 2), _tokens(tm.cfg, 2, 13, 2)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                 "src_embeds": jnp.asarray(src)})
    tl, tc = tm.prefill({"tokens": toks, "src_embeds": src})
    assert tl.shape == jl.shape == (2, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert sorted(tc[0][0]) == ["mix", "xk", "xv"]
    assert tuple(tc[0][0]["xk"].shape) == (2, 2, SRC, 16, 32)   # MHA: padded
    assert cache_has_state(tc)                  # snapshots, not pages


def test_suffix_prefill_over_a_snapshot_uses_its_cross_kv(pair):
    """A suffix prefill over a cache that holds cross K/V attends to them,
    whatever ``src_embeds`` the batch carries (JAX's ``_layer_apply`` reads
    the cached K/V whenever the cache has them); with the prefix's own
    source it equals the full prefill. New caches; the snapshot kept."""
    jm, params, tm = pair
    src, other = _src(tm.cfg, 1, 3), _src(tm.cfg, 1, 4)
    toks = _tokens(tm.cfg, 1, 24, 3)
    P = 16
    _, jpre = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P],
                                                        jnp.int32),
                                  "src_embeds": jnp.asarray(src)})
    _, tpre = tm.prefill({"tokens": toks[:, :P], "src_embeds": src})
    kept = tpre[0][0]["mix"]["k"].clone()
    for batch_src in (src, other):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, P:],
                                                           jnp.int32),
                                     "src_embeds": jnp.asarray(batch_src)},
                            caches=jpre, pos=P)
        tl, tc = tm.prefill({"tokens": toks[:, P:], "src_embeds": batch_src},
                            caches=tpre, pos=P)
        _close(tl, jl)
        _caches_close(tc, jc)
    assert torch.equal(tpre[0][0]["mix"]["k"], kept)
    full, _ = tm.prefill({"tokens": toks, "src_embeds": src})
    _close(tl, full)
    # the cached cross K/V are read: no source is needed at all
    alone, _ = tm.prefill({"tokens": toks[:, P:]}, caches=tpre, pos=P)
    _close(alone, full)


def test_decode_steps_match_jax(pair):
    """Decode over the prefill's caches (K/V padded to a capacity, the cross
    K/V as they are), 4 steps, batch of 2."""
    jm, params, tm = pair
    src, toks = _src(tm.cfg, 2, 5), _tokens(tm.cfg, 2, 14, 5)
    n, cap = 10, 16
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n], jnp.int32),
                                "src_embeds": jnp.asarray(src)})
    _, tc = tm.prefill({"tokens": toks[:, :n], "src_embeds": src})

    def pad_j(path, a):
        if str(getattr(path[-1], "key", "")) in ("k", "v"):
            return jnp.pad(a, [(0, 0), (0, 0), (0, cap - n), (0, 0), (0, 0)])
        return a
    jc = jax.tree_util.tree_map_with_path(pad_j, jc)
    tc = [[{**l, "mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0,
                                                        cap - n))
                         for k, t in l["mix"].items()}} for l in s]
          for s in tc]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        _close(tl, jl)
    _caches_close(tc, jc)
    want, _ = tm.prefill({"tokens": toks, "src_embeds": src})
    _close(tl, want)


def test_init_cache_with_src_len_matches_jax():
    """``init_cache(src_len=)`` adds the cross K/V to every entry; int8 is
    refused for them (JAX would read their codes as values) and allowed
    for a cache without them (attention K/V only)."""
    jm, tm = jbuild(JSMOKES[ARCH]), build_model(SMOKES[ARCH], device="cpu")
    for src_len in (0, 12):
        jc, tc = jm.init_cache(3, 40, src_len=src_len), \
            tm.init_cache(3, 40, src_len=src_len)
        shapes = lambda c: [[{k: tuple(t.shape) for k, t in
                              jax.tree_util.tree_leaves_with_path(l)}
                             for l in s] for s in c]
        assert [[{"/".join(str(getattr(p, "key", p)) for p in k): v
                  for k, v in d.items()} for d in s] for s in shapes(jc)] \
            == [[{"/".join(map(str, k)): tuple(v.shape) for k, v in
                  _leaves(l)} for l in s] for s in tc]
    assert tuple(tc[0][0]["xv"].shape) == (2, 3, 12, 16, 32)
    with pytest.raises(ValueError, match="cross K/V"):
        tm.init_cache(2, 16, kv_dtype=torch.int8, src_len=12)
    assert tm.init_cache(2, 16, kv_dtype=torch.int8)[0][0]["mix"]["k"].dtype \
        == torch.int8


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                          path + (k,))]
    return [(path, tree)]


def test_full_width_plan_and_parameter_count():
    """12 decoder layers with cross-attention, 12 encoder layers, 16 MHA
    heads of 64, the 256206-row vocab padded to 256208 (its tail masked)."""
    cfg = ARCHS[ARCH]
    tm = build_model(cfg, device="meta")
    assert [(s.count, s.kinds, s.cross) for s in tm.segments] == \
        [(12, (("attn", False, 0),), True)]
    assert len(tm.encoder) == 12 and tm.encoder[0].xattn is None
    assert tm.vocab_padded == 256208
    n = sum(p.numel() for p in tm.parameters())
    assert 0.977e9 < n < 0.978e9
    small = build_model(SMOKES[ARCH], device="cpu", dtype=torch.float32)
    small.cfg = dataclasses.replace(small.cfg, vocab=510)
    lg = small._logits(torch.ones(1, 1, small.cfg.d_model))
    assert torch.all(lg[..., 510:] == -1e30) and torch.all(lg[..., :510] > -1)


def test_decode_batch_greedy_tokens_equal_jax(pair):
    """The cross K/V are per-sequence state leaves of the stacked batch,
    sized from the first cache admitted: one ``src_len`` a decode unit, in
    both packages; a cache of another ``src_len`` is refused."""
    jm, params, tm = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(n,)) for n in (12, 19, 7)]
    teng, jeng = ServingEngine(tm), JServingEngine(jm, params)
    tdb = DecodeBatch(tm, capacity=32, max_slots=4)
    jdb = JDecodeBatch(jm, params, capacity=32, max_slots=4)
    got, want = {}, {}
    for rid, p in enumerate(prompts):
        extra = {"src_embeds": _src(tm.cfg, 1, 10 + rid)}
        t0, tc, _ = teng.prefill(p, extra=extra)
        j0, jc, _ = jeng.prefill(p, extra=extra)
        assert t0 == j0
        tdb.add(rid, tc, len(p), t0, max_new=3 + rid)
        jdb.add(rid, jc, len(p), j0, max_new=3 + rid)
        got[rid], want[rid] = [t0], [j0]
    assert tuple(tdb._stacked[0][0]["xk"].shape) == (2, 4, SRC, 16, 32)
    while jdb.n_active:
        for rid, t in tdb.step().items():
            got[rid].append(t)
        for rid, t in jdb.step().items():
            want[rid].append(t)
    assert not tdb.n_active and got == want
    extra = {"src_embeds": _src(tm.cfg, 1, 20, S=SRC + 4)}
    _, tc, _ = teng.prefill(prompts[0], extra=extra)
    with pytest.raises(RuntimeError):
        tdb.add(9, tc, len(prompts[0]), 0)


def _stream(cfg, req_cls):
    """``agent_requests`` at the smoke's size: warm prompts, follow-ups that
    extend them with their sources, fresh prompts with their own."""
    return [req_cls(rid=r.rid, arrival=r.arrival, tokens=r.tokens,
                    max_new=3, extra=r.extra)
            for r in agent_requests(cfg, 5, seed=2, prompt=24, extend=8,
                                    fresh=32)]


def test_disagg_server_results_equal_jax_with_snapshot_hits(pair):
    jm, params, tm = pair
    reqs = _stream(tm.cfg, JServeRequest)
    assert all(r.extra["src_embeds"].shape == (1, src_len_for(24),
                                               tm.cfg.d_model)
               for r in reqs)
    srv = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=2, n_pages=128,
                                            hw=A100))
    jsrv = JDisaggServer(jm, params, cfg=JDisaggConfig(
        n_prefill_units=2, n_pages=128, hw=JA100))
    got = srv.serve(_stream(tm.cfg, ServeRequest))
    want = jsrv.serve(reqs)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert any(r.reused_tokens == 24 for r in got)          # snapshot hits


def test_launcher_and_example_serve_the_encdec_smoke_on_cpu():
    summary = run(ARCH, device="cpu", n_requests=6, policies=("mfs",),
                  verbose=False)
    assert 0.0 <= summary["mfs"]["slo_attainment"] <= 1.0
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/serve_disagg_torch.py"),
         "--arch", ARCH, "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    rows = [l for l in out.stdout.splitlines() if "reused" in l]
    assert len(rows) == 4
    assert all(int(l.split("reused")[1].split()[0]) >= 96 for l in rows)
