"""The port's hybrid slice (RecurrentGemma: RG-LRU blocks and local
attention) held against the JAX package on the same numpy inputs: the
RG-LRU oracle against ``repro.kernels.ref`` and the Pallas ``rglru_scan`` in
interpret mode, the depth-5 recurrentgemma smoke model (both segments, a
prompt longer than the window: prefill, suffix prefill over a cropped
cache, decode through the rolled ring; logits and caches) through
``from_jax_params``, greedy ``DecodeBatch`` tokens, every ``ServeResult``
field of both ``DisaggServer``s on a stream that resumes snapshots, and the
snapshot bytes that size the Stage-1 flow."""
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

from _off_card import off_card
from repro.configs import SMOKES as JSMOKES
from repro.kernels import ref as jref
from repro.kernels.rglru import rglru_scan as jrglru_scan
from repro.models.lm import build_model as jbuild
from repro.serving import DecodeBatch as JDecodeBatch
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import DisaggServer as JDisaggServer
from repro.serving import ServeRequest as JServeRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.paged_kv import cache_bytes as jcache_bytes
from repro.simcluster.hw import A100 as JA100
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rglru import (CHUNK, THREADS, rglru_cost, rglru_plan,
                                       rglru_scan, rglru_scan_plain)
from repro_torch.launch.serve import run
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (DecodeBatch, DisaggConfig, DisaggServer,
                                 ServeRequest, ServingEngine, cache_has_state)
from repro_torch.serving.paged_kv import cache_bytes, tree_leaves_with_path
from repro_torch.simcluster.hw import A100

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4          # float32 through 5-layer models, summation order differs
KTOL = 1e-4         # the RG-LRU kernel's tolerance, as tests/test_kernels.py
ARCH = "recurrentgemma-9b"
LAYERS = 5          # one (rec, rec, attn) unit and the (rec, rec) tail


# ------------------------------------------------------------------ oracle
def _rglru_inputs(B, T, W, with_init, seed=0):
    """As tests/test_kernels.py: a in [0.7, 0.999], x and the state N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, size=(B, T, W)).astype(np.float32)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    s0 = rng.normal(size=(B, W)).astype(np.float32) if with_init else None
    return a, x, s0


def _t(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,T,W", [(2, 64, 256), (1, 200, 100), (3, 33, 512)])
@pytest.mark.parametrize("with_init", [False, True])
def test_rglru_oracle_matches_jax_and_pallas_interpret(B, T, W, with_init):
    arrs = _rglru_inputs(B, T, W, with_init, seed=T)
    a, x, s0 = _j(arrs)
    jh, js = jref.rglru_ref(a, x, init_state=s0)
    ph, ps = jrglru_scan(a, x, init_state=s0, chunk=64, interpret=True)
    for fn in (tref.rglru_ref, tops.rglru):
        th, ts = fn(*_t(arrs))
        assert th.dtype == ts.dtype == torch.float32
        for want_h, want_s in ((jh, js), (ph, ps)):
            _close(th, want_h, KTOL)
            _close(ts, want_s, KTOL)


def test_rglru_decay_semantics():
    """a == 0 wipes history; a == 1 accumulates exactly."""
    B, T, W = 1, 16, 128
    x = torch.ones(B, T, W)
    h0, _ = rglru_scan(torch.zeros(B, T, W), x)
    assert torch.equal(h0, torch.ones(B, T, W))
    h1, s1 = rglru_scan(torch.ones(B, T, W), x)
    assert torch.equal(h1[0, -1], torch.full((W,), float(T)))
    assert torch.equal(s1, h1[:, -1])


def test_ops_rglru_on_the_cpu_is_the_plain_version():
    arrs = _t(_rglru_inputs(2, 17, 40, True, seed=4))
    got, want = tops.rglru(*arrs), tref.rglru_ref(*arrs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tops.rglru is rglru_scan and rglru_scan_plain is tref.rglru_ref


def test_rglru_state_chains_across_calls():
    """Splitting a sequence across two calls == one long call (a suffix
    prefill over a snapshot relies on it), and zero steps give the state
    back."""
    a, x, _ = _t(_rglru_inputs(1, 64, 100, False, seed=5))
    h, s = rglru_scan(a, x)
    h1, s1 = rglru_scan(a[:, :32], x[:, :32])
    h2, s2 = rglru_scan(a[:, 32:], x[:, 32:], s1)
    _close(torch.cat([h1, h2], 1), h, KTOL)
    _close(s2, s, KTOL)
    h0, s0 = rglru_scan(a[:, :0], x[:, :0], s)
    assert h0.shape == (1, 0, 100) and torch.equal(s0, s)


def test_rglru_scan_has_no_kernel_off_cuda():
    """On neither the CPU nor the card nor meta (``_off_card``)."""
    a, x, _ = (None if t is None else off_card(t)
               for t in _t(_rglru_inputs(1, 4, 8, False)))
    with pytest.raises(ValueError, match="no kernel"):
        rglru_scan(a, x)


def test_rglru_cost_at_the_serve_shapes():
    flops, nbytes = rglru_cost(1, 2112, 4096, False)
    assert flops == 2 * 2112 * 4096
    assert nbytes == 4 * (3 * 2112 * 4096 + 4096)           # ~104 MB
    _, dec = rglru_cost(8, 1, 4096, True)
    assert dec == 4 * (3 * 8 * 4096 + 2 * 8 * 4096)


@pytest.mark.parametrize("B,T,W,want", [
    (1, 2112, 4096, (33, 64, 2112, 2113, 3 * 32 * 4096)),   # full prefill
    (1, 32, 4096, (1, 64, 64, 0, 0)),                       # suffix
    (8, 1, 4096, (1, 64, 512, 0, 0)),                       # decode
    (3, 64, 1000, (1, 16, 48, 0, 0)),                       # one chunk
    (3, 65, 1000, (2, 16, 96, 97, 3 * 3 * 1000)),
    (3, 4103, 1000, (65, 16, 3120, 3121, 3 * 3 * 64 * 1000)),
    (2, 0, 100, (1, 2, 4, 0, 0))])
def test_rglru_plan_one_pass(B, T, W, want):
    """The launch ``rglru_scan`` makes, as Python ints: chunks of CHUNK
    steps, blocks of THREADS channels, one block each (chunk, sequence,
    channel block), and for more than one chunk the flags (the ticket
    first, one a (sequence, channel block, chunk)) and the carries (prod
    a, end, inclusive end) of every chunk but the last."""
    assert (CHUNK, THREADS) == (64, 64)
    plan = rglru_plan(B, T, W)
    assert tuple(plan) == want
    assert plan.grid == plan.chunks * B * plan.channel_blocks


def _look_back_scan(a, x, s0, order, chunk=4):
    """The one-pass kernel's arithmetic on the CPU, chunk by chunk in the
    ``order`` their blocks resolve: each chunk's (prod a, end from zero),
    then its carry by walking back over its predecessors, composing an
    aggregate where that chunk has no inclusive end yet and stopping at
    the first that has one; then the rescan from the carry."""
    B, T, W = a.shape
    nc = -(-T // chunk)
    prod, end, incl = {}, {}, {}
    h = torch.empty(B, T, W)
    for c in range(nc):
        ac, xc = a[:, c * chunk:(c + 1) * chunk], x[:, c * chunk:(c + 1) * chunk]
        p, e = torch.ones(B, W), torch.zeros(B, W)
        for u in range(ac.shape[1]):
            e = ac[:, u] * e + xc[:, u]
            p = p * ac[:, u]
        prod[c], end[c] = p, e
    for c in order:
        carry = s0.clone()
        if c > 0:
            pa, ea = torch.ones(B, W), torch.zeros(B, W)
            for k in range(c - 1, -1, -1):
                if k in incl:
                    carry = pa * incl[k] + ea
                    break
                ea = pa * end[k] + ea
                pa = pa * prod[k]
            else:
                carry = pa * s0 + ea
        incl[c] = prod[c] * carry + end[c]
        s = carry
        for u in range(c * chunk, min(T, (c + 1) * chunk)):
            s = a[:, u] * s + x[:, u]
            h[:, u] = s
    return h, incl[nc - 1]


@pytest.mark.parametrize("order", ["in order", "reversed", "shuffled"])
def test_rglru_look_back_composition_equals_the_recurrence(order):
    """Whatever predecessors have resolved when a chunk looks back, its
    carry composed from their aggregates and the first inclusive end equals
    the sequential state (the plain version's and the Pallas kernel's)."""
    arrs = _rglru_inputs(2, 37, 24, True, seed=8)
    a, x, s0 = _t(arrs)
    nc = -(-37 // 4)
    resolve = {"in order": list(range(nc)),
               "reversed": list(range(nc))[::-1],
               "shuffled": list(np.random.default_rng(0).permutation(nc))}
    h, s = _look_back_scan(a, x, s0, [int(c) for c in resolve[order]])
    want = tref.rglru_ref(a, x, s0)
    jh, js = jrglru_scan(*_j(arrs[:2]), init_state=jnp.asarray(arrs[2]),
                         interpret=True)
    for got, w, jw in ((h, want[0], jh), (s, want[1], js)):
        _close(got, w, KTOL)
        _close(got, jw, KTOL)


# -------------------------------------------------------------------- model
def _cfgs():
    return (dataclasses.replace(JSMOKES[ARCH], n_layers=LAYERS),
            dataclasses.replace(SMOKES[ARCH], n_layers=LAYERS))


def _models(seed=0):
    jcfg, tcfg = _cfgs()
    jm = dataclasses.replace(jbuild(jcfg), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(seed)))
    # JAX inits a_param to one deterministic ramp in every layer, which would
    # hide a mixed-up layer or channel order: give each its own values
    rng = np.random.default_rng(11)
    for seg in ("seg0", "seg1"):
        for sub in params[seg]:
            if "a_param" in sub["mix"]:
                lam = rng.uniform(0.8, 0.999, size=sub["mix"]["a_param"].shape)
                sub["mix"]["a_param"] = jnp.asarray(
                    np.log(np.expm1(lam ** (1 / 8.0))), jnp.float32)
    tm = build_model(tcfg, device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _models()


def _caches_close(tc, jc):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        t = tc
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(t.shape) == leaf.shape and \
            str(t.dtype)[6:] == str(leaf.dtype), path
        _close(t, leaf)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(1, n))


def _snapshot(caches):
    return [[{"mix": {k: t.clone() for k, t in layer["mix"].items()}}
             for layer in seg] for seg in caches]


def test_full_prefill_past_the_window_matches_jax(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 1)                  # window 16: cropped cache
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill({"tokens": toks})
    assert tl.shape == jl.shape == (1, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert tc[0][2]["mix"]["k"].shape[2] == tm.cfg.window


def test_suffix_prefill_over_a_cropped_cache_matches_jax(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 28, 2)
    P = 20                      # the prefix cache keeps its last 16 positions
    _, jpre = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P],
                                                        jnp.int32)})
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, P:],
                                                       jnp.int32)},
                        caches=jpre, pos=P)
    _, tpre = tm.prefill({"tokens": toks[:, :P]})
    before = _snapshot(tpre)
    tl, tc = tm.prefill({"tokens": toks[:, P:]}, caches=tpre, pos=P)
    _close(tl, jl)
    _caches_close(tc, jc)
    full, _ = tm.prefill({"tokens": toks})          # reuse is exact
    _close(tl, full)
    for (_, a), (_, b) in zip(tree_leaves_with_path(tpre),
                              tree_leaves_with_path(before)):
        assert torch.equal(a, b)                     # the snapshot is intact


def _roll_window_leaves(caches, n, roll):
    """Admit a B=1 prefill cache as ``DecodeBatch.add`` does: each window
    leaf holding positions [n - S, n) goes into ring order."""
    out = []
    for seg in caches:
        out.append([{"mix": {k: roll(t, (n - t.shape[2]) % t.shape[2])
                             if k in ("k", "v") else t
                             for k, t in layer["mix"].items()}}
                    for layer in seg])
    return out


def test_decode_steps_through_the_ring_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 28, 3)
    n = 24
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                      jnp.int32)})
    _, tc = tm.prefill({"tokens": toks[:, :n]})
    jc = _roll_window_leaves(jc, n, lambda t, r: jnp.roll(t, r, axis=2))
    tc = _roll_window_leaves(tc, n, lambda t, r: torch.roll(t, r, dims=2))
    k = tc[0][2]["mix"]["k"]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, out = tm.decode_step(tc, tok, n + step)
        assert out[0][2]["mix"]["k"] is k            # written in place
        _close(tl, jl)
    _caches_close(tc, jc)
    # the ring's slot (n + 3) % 16 holds the last token's key
    assert not torch.equal(k[0, 0, (n + 3) % 16], torch.zeros_like(k[0, 0, 0]))


def test_init_and_cache_shapes_match_jax():
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        if keys[0].startswith("seg"):
            for c in range(leaf.shape[0]):
                want[".".join([keys[0], str(c)] + keys[1:])] = \
                    (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {k: (tuple(v.shape), str(v.dtype)[6:])
           for k, v in tm.state_dict().items()}
    assert got == want      # incl. unembed, a_param float32 in bf16
    _close(tm.seg0[0][0].mix.a_param,
           np.asarray(params["seg0"][0]["mix"]["a_param"][0]), 1e-5)
    for max_len in (10, 40):                        # below / above the window
        jc, tc = jm.init_cache(3, max_len), tm.init_cache(3, max_len)
        assert [[{k: (tuple(t.shape), str(t.dtype)[6:])
                  for k, t in l["mix"].items()} for l in s] for s in tc] == \
            [[{k: (t.shape, str(t.dtype)) for k, t in l["mix"].items()}
              for l in s] for s in jc]


def test_full_width_plan_and_shapes():
    tm = build_model(ARCHS[ARCH], device="meta")
    unit = (("rec", False, 0), ("rec", False, 0), ("attn", False, 2048))
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(12, unit), (1, unit[:2])]
    rec, attn = tm.seg0[0][0], tm.seg0[0][2]
    assert tuple(rec.mix.gate_in.shape) == (16, 256, 256)
    assert tuple(rec.mix.conv.shape) == (4, 4096)
    assert rec.ffn is not None and tuple(rec.ffn.wi.w.shape) == (4096, 12288)
    assert tuple(attn.mix.wk.w.shape) == (4096, 256)        # 1 kv head
    assert tuple(tm.unembed.w.shape) == (4096, 256000)
    n = sum(p.numel() for p in tm.parameters())
    assert 9.6e9 < n < 9.7e9


# ------------------------------------------------------------------ serving
def test_decode_batch_greedy_tokens_equal_jax(pair):
    """Prompts shorter and longer than the window of 16: the longer one is
    admitted through the roll, and decoding wraps the ring."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(n,)) for n in (12, 19)]
    teng, jeng = ServingEngine(tm), JServingEngine(jm, params)
    tdb = DecodeBatch(tm, capacity=32, max_slots=4)
    jdb = JDecodeBatch(jm, params, capacity=32, max_slots=4)
    got, want = {}, {}
    for rid, p in enumerate(prompts):
        t0, tc, _ = teng.prefill(p)
        j0, jc, _ = jeng.prefill(p)
        assert t0 == j0
        tdb.add(rid, tc, len(p), t0, max_new=8)
        jdb.add(rid, jc, len(p), j0, max_new=8)
        got[rid], want[rid] = [t0], [j0]
    assert tdb._stacked[0][2]["mix"]["k"].shape[2] == 16     # min(32, 16)
    while jdb.n_active:
        for rid, t in tdb.step().items():
            got[rid].append(t)
        for rid, t in jdb.step().items():
            want[rid].append(t)
    assert not tdb.n_active and got == want


def _agent_stream(cfg, req_cls, seed=6):
    """A warm wave of whole 24-token prompts (past the window), then
    follow-ups that extend them and fresh prompts."""
    rng = np.random.default_rng(seed)
    warm = [rng.integers(0, cfg.vocab, size=(24,)) for _ in range(2)]
    reqs = [req_cls(rid=i, arrival=i * 0.05, tokens=p, max_new=3)
            for i, p in enumerate(warm)]
    for i in range(4):
        if i % 2 == 0:
            toks = np.concatenate([warm[i // 2],
                                   rng.integers(0, cfg.vocab, size=(8,))])
        else:
            toks = rng.integers(0, cfg.vocab, size=(32,))
        reqs.append(req_cls(rid=2 + i, arrival=0.15 + i * 1e-3, tokens=toks,
                            max_new=3))
    return reqs


def test_disagg_server_results_equal_jax_with_snapshot_hits(pair):
    jm, params, tm = pair
    srv = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=2, n_pages=128,
                                            hw=A100))
    jsrv = JDisaggServer(jm, params, cfg=JDisaggConfig(
        n_prefill_units=2, n_pages=128, hw=JA100))
    got = srv.serve(_agent_stream(tm.cfg, ServeRequest))
    want = jsrv.serve(_agent_stream(tm.cfg, JServeRequest))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert sum(r.reused_tokens == 24 for r in got) == 2     # snapshot hits
    assert all(0 <= t < tm.cfg.vocab for r in got for t in r.tokens)


def test_snapshot_bytes_equal_jax_in_bf16():
    """The bytes that size the Stage-1 flow: window-cropped k/v and the conv
    window in bf16, the state in float32, in both packages, for an empty
    cache and for the snapshot of a prompt past the window."""
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    for n in (7, 40):
        assert cache_bytes(tm.init_cache(1, n)) == jcache_bytes(
            jm.init_cache(1, n))
    toks = _tokens(tcfg, 24, 8)
    _, tc = tm.prefill({"tokens": toks})
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert cache_has_state(tc)
    assert tc[0][2]["mix"]["k"].dtype == torch.bfloat16
    assert cache_bytes(tc) == jcache_bytes(jc)


def test_launcher_runs_the_hybrid_on_cpu_when_asked():
    summary = run(ARCH, device="cpu", n_requests=6, policies=("mfs",),
                  verbose=False)
    s = summary["mfs"]
    assert 0.0 <= s["slo_attainment"] <= 1.0 and s["mean_ttft_ms"] > 0.0


def test_example_serves_the_hybrid_on_cpu_with_snapshot_reuse():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/serve_disagg_torch.py"),
         "--arch", ARCH, "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    rows = [l for l in out.stdout.splitlines() if "reused" in l]
    assert len(rows) == 4
    assert all(int(l.split("reused")[1].split()[0]) >= 96 for l in rows)
