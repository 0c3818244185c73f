"""The port's mixture-of-experts slice (deepseek-moe-16b: a dense first
layer, then routed top-k experts with shared ones) held against the JAX
package on the same numpy inputs and the same weights, converted from the
JAX ``Model.init`` tree: routing, the sorted grouped path and the token
gather, ``moe_apply`` with the shared experts, the two-segment smoke model
(full prefill, suffix prefill over a reused prefix, decode; logits and
caches), greedy ``DecodeBatch`` tokens and every ``ServeResult`` field of
both ``DisaggServer``s on a stream with prefix hits."""
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
from repro.models import blocks as jblocks
from repro.models.lm import build_model as jbuild
from repro.models.sharding import ShardCtx
from repro.serving import DecodeBatch as JDecodeBatch
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import DisaggServer as JDisaggServer
from repro.serving import ServeRequest as JServeRequest
from repro.serving import ServingEngine as JServingEngine
from repro.simcluster.hw import A100 as JA100
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.launch.serve import run
from repro_torch.models import blocks, build_model, from_jax_params
from repro_torch.serving import (DecodeBatch, DisaggConfig, DisaggServer,
                                 ServeRequest, ServingEngine, cache_has_state)
from repro_torch.simcluster.hw import A100

ROOT = Path(__file__).resolve().parent.parent
ARCH = "deepseek-moe-16b"
TOL = 2e-4          # float32 through the model, as tests/test_torch_hybrid.py
MOE_TOL = 1e-5      # one MoE layer in float32, as tests/test_models.py


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _models(seed=0):
    jm = dataclasses.replace(jbuild(JSMOKES[ARCH]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(SMOKES[ARCH], device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _models()


def _moe_layer(pair, c=0):
    """The ``c``-th MoE layer of both models: (JAX params, port module)."""
    jm, params, tm = pair
    jp = jax.tree.map(lambda a: a[c], params["seg1"][0]["ffn_moe"])
    return jp, tm.seg1[c][0].ffn_moe


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


# --------------------------------------------------------------- the layer
def test_route_matches_jax(pair):
    jp, tp = _moe_layer(pair)
    cfg = SMOKES[ARCH]
    x = _x(cfg, (40,), 1)
    jg, ji = jblocks._route(jnp.asarray(x), jp["router"], cfg.top_k)
    tg, ti = blocks._route(torch.from_numpy(x), tp.router, cfg.top_k)
    assert tg.dtype == torch.float32 and ti.shape == (40, cfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, 1e-6)
    _close(tg.sum(-1), np.ones(40), 1e-6)


def test_moe_local_equals_token_gather(pair):
    """The port's counterpart of tests/test_models.py's
    ``test_moe_gather_matches_ragged``."""
    _, tp = _moe_layer(pair)
    cfg = SMOKES[ARCH]
    x = torch.from_numpy(_x(cfg, (3, 2), 2))
    _close(blocks._moe_local(tp, x, cfg),
           blocks._moe_token_gather(tp, x, cfg), MOE_TOL)


@pytest.mark.parametrize("shape", [(3, 2), (1, 33), (2, 1)])
def test_moe_local_and_token_gather_match_jax(pair, shape):
    jp, tp = _moe_layer(pair)
    cfg = SMOKES[ARCH]
    jcfg = JSMOKES[ARCH]
    x = _x(cfg, shape, 3)
    for tfn, jfn in ((blocks._moe_local, jblocks._moe_local),
                     (blocks._moe_token_gather, jblocks._moe_token_gather)):
        got = tfn(tp, torch.from_numpy(x), cfg)
        want = jfn(jp, jnp.asarray(x), jcfg)
        assert got.shape == want.shape == shape + (cfg.d_model,)
        _close(got, want, MOE_TOL)
    # the two JAX paths against each other too, so a shared fault shows
    _close(jblocks._moe_local(jp, jnp.asarray(x), jcfg),
           blocks._moe_token_gather(tp, torch.from_numpy(x), cfg), MOE_TOL)


@pytest.mark.parametrize("sizes", [[3, 0, 5, 0, 0, 1, 0, 7],
                                   [0, 0, 0, 16, 0, 0, 0, 0],
                                   [1] * 8, [0] * 7 + [2]])
def test_expert_ffn_matches_jax_ragged_dot(pair, sizes):
    """The grouped SwiGLU alone, on rows sorted by expert: empty groups, one
    group holding every row (the buffer as deep as the input), one row a
    group."""
    jp, tp = _moe_layer(pair)
    x = _x(SMOKES[ARCH], (sum(sizes),), 6)
    expert = torch.repeat_interleave(torch.arange(8), torch.tensor(sizes))
    got = blocks._expert_ffn(tp.w_in, tp.w_gate, tp.w_out,
                             torch.from_numpy(x), expert)
    want = jblocks._expert_ffn(jp["w_in"], jp["w_gate"], jp["w_out"],
                               jnp.asarray(x), jnp.asarray(sizes, jnp.int32))
    assert got.shape == want.shape
    _close(got, want, MOE_TOL)


def test_grouped_path_equals_a_loop_over_tokens(pair):
    """Every token through its own experts one by one, gated and summed:
    the sort, the group offsets (empty groups included) and the scatter back
    keep each row with its token."""
    _, tp = _moe_layer(pair, c=0)
    cfg = SMOKES[ARCH]
    x = torch.from_numpy(_x(cfg, (1, 5), 4))
    xf = x.reshape(-1, cfg.d_model)
    gates, idx = blocks._route(xf, tp.router, cfg.top_k)
    assert len(set(idx.flatten().tolist())) < cfg.n_experts   # empty groups
    want = torch.zeros_like(xf)
    for n in range(xf.shape[0]):
        for k in range(cfg.top_k):
            e = int(idx[n, k])
            h = torch.nn.functional.silu(xf[n] @ tp.w_gate[e]) * \
                (xf[n] @ tp.w_in[e])
            want[n] += gates[n, k] * (h @ tp.w_out[e])
    _close(blocks._moe_local(tp, x, cfg).reshape(-1, cfg.d_model), want,
           MOE_TOL)


@pytest.mark.parametrize("mode,shape", [("prefill", (2, 9)),
                                        ("decode", (4, 1))])
def test_moe_apply_with_shared_experts_matches_jax(pair, mode, shape):
    jp, tp = _moe_layer(pair)
    cfg = SMOKES[ARCH]
    assert tp.shared is not None and tuple(tp.shared.wi.w.shape) == \
        (cfg.d_model, cfg.n_shared * cfg.d_expert)
    x = _x(cfg, shape, 5)
    got = blocks.moe_apply(tp, torch.from_numpy(x), cfg=cfg, mode=mode)
    want = jblocks.moe_apply(jp, jnp.asarray(x), cfg=JSMOKES[ARCH],
                             ctx=ShardCtx(), mode=mode)
    _close(got, want, MOE_TOL)
    routed = got - tp.shared(torch.from_numpy(x))
    assert float(routed.abs().max()) > 1e-3          # the experts do work


# -------------------------------------------------------------------- model
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


def test_full_prefill_matches_jax(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 21, 1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill({"tokens": toks})
    assert tl.shape == jl.shape == (1, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert len(tc) == 2 and not cache_has_state(tc)   # pageable k/v only


def test_suffix_prefill_over_a_reused_prefix_matches_jax(pair):
    """tests/test_models.py's semantics: a prefill resumed over the cache of
    the first P tokens equals the full prefill, in both packages."""
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 2)
    P = 16
    _, jpre = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P],
                                                        jnp.int32)})
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, P:],
                                                       jnp.int32)},
                        caches=jpre, pos=P)
    _, tpre = tm.prefill({"tokens": toks[:, :P]})
    tl, tc = tm.prefill({"tokens": toks[:, P:]}, caches=tpre, pos=P)
    _close(tl, jl)
    _caches_close(tc, jc)
    full, _ = tm.prefill({"tokens": toks})
    _close(tl, full)


def test_decode_steps_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 20, 3)
    n, cap = 16, 24
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                      jnp.int32)})
    _, tc = tm.prefill({"tokens": toks[:, :n]})
    pad = [(0, 0), (0, 0), (0, cap - n), (0, 0), (0, 0)]
    jc = jax.tree.map(lambda a: jnp.pad(a, pad), jc)
    tc = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cap - n))
                    for k, t in l["mix"].items()}} for l in s] for s in tc]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        _close(tl, jl)
    _caches_close(tc, jc)


def test_init_and_cache_shapes_match_jax():
    """Names, shapes and dtypes of every parameter in bf16, the router
    float32 as in JAX; the two-segment cache tree."""
    jm = jbuild(JSMOKES[ARCH])
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(SMOKES[ARCH], device="cpu",
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
    assert got == want
    assert got["seg1.0.0.ffn_moe.router"][1] == "float32"
    assert got["seg1.0.0.ffn_moe.w_in"][1] == "bfloat16"
    assert "seg0.0.0.ffn.wi.w" in got and "seg0.0.0.ffn_moe.router" not in got
    # the init scales of JAX's moe_init: N(0, 1/d) in, N(0, 1/F) out
    moe = tm.seg1[0][0].ffn_moe
    for w, scale in ((moe.router, SMOKES[ARCH].d_model ** -0.5),
                     (moe.w_out.float(), SMOKES[ARCH].d_expert ** -0.5)):
        assert abs(float(w.std()) / scale - 1.0) < 0.05
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
    assert [[{k: (tuple(t.shape), str(t.dtype)[6:])
              for k, t in l["mix"].items()} for l in s] for s in tc] == \
        [[{k: (t.shape, str(t.dtype)) for k, t in l["mix"].items()}
          for l in s] for s in jc]


def test_conversion_is_strict_over_the_moe_tree():
    jm = jbuild(JSMOKES[ARCH])
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKES[ARCH], device="cpu")
    from_jax_params(params, tm)
    assert tm.seg1[0][0].ffn_moe.router.dtype == torch.float32
    _close(tm.seg1[0][0].ffn_moe.router,
           params["seg1"][0]["ffn_moe"]["router"][0], 0.0)
    for drop in ("router", "shared"):
        bad = jax.tree.map(lambda a: a, params)
        del bad["seg1"][0]["ffn_moe"][drop]
        with pytest.raises(KeyError, match="missing"):
            from_jax_params(bad, build_model(SMOKES[ARCH], device="cpu"))
    bad = jax.tree.map(lambda a: a, params)
    bad["seg0"][0]["ffn_moe"] = bad["seg1"][0]["ffn_moe"]
    with pytest.raises(KeyError, match="unexpected"):
        from_jax_params(bad, build_model(SMOKES[ARCH], device="cpu"))


def test_full_width_plan_and_parameter_count():
    cfg = ARCHS[ARCH]
    tm = build_model(cfg, device="meta")
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(1, (("attn", False, 0),)), (27, (("attn", True, 0),))]
    dense, moe = tm.seg0[0][0], tm.seg1[0][0]
    assert dense.ffn_moe is None and tuple(dense.ffn.wi.w.shape) == \
        (2048, 10944)
    assert moe.ffn is None
    assert tuple(moe.ffn_moe.w_in.shape) == (64, 2048, 1408)
    assert tuple(moe.ffn_moe.w_out.shape) == (64, 1408, 2048)
    assert tuple(moe.ffn_moe.shared.wi.w.shape) == (2048, 2 * 1408)
    assert tuple(moe.mix.wk.w.shape) == (2048, 16 * 128)     # MHA, hd 128
    n = sum(p.numel() for p in tm.parameters())
    # cfg.params() counts every layer's two norms but not the final one
    assert n == cfg.params() + cfg.d_model
    assert 16.37e9 < n < 16.38e9


# ------------------------------------------------------------------ serving
def test_decode_batch_greedy_tokens_equal_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(n,)) for n in (12, 19, 7)]
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
    assert len(tdb._stacked) == 2                    # both segments stacked
    while jdb.n_active:
        for rid, t in tdb.step().items():
            got[rid].append(t)
        for rid, t in jdb.step().items():
            want[rid].append(t)
    assert not tdb.n_active and got == want


def _requests(cfg, req_cls):
    """Half the requests share a 32-token prefix (two pages)."""
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


def test_disagg_server_results_equal_jax_with_prefix_hits(pair):
    jm, params, tm = pair
    srv = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=2, n_pages=128,
                                            hw=A100))
    jsrv = JDisaggServer(jm, params, cfg=JDisaggConfig(
        n_prefill_units=2, n_pages=128, hw=JA100))
    got = srv.serve(_requests(tm.cfg, ServeRequest))
    want = jsrv.serve(_requests(tm.cfg, JServeRequest))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert any(r.reused_tokens >= 32 for r in got)
    assert all(0 <= t < tm.cfg.vocab for r in got for t in r.tokens)


def test_launcher_runs_the_moe_smoke_on_cpu_when_asked():
    summary = run(ARCH, device="cpu", n_requests=6, policies=("mfs",),
                  verbose=False)
    s = summary["mfs"]
    assert 0.0 <= s["slo_attainment"] <= 1.0 and s["mean_ttft_ms"] > 0.0


def test_example_serves_the_moe_smoke_on_cpu_with_reuse():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/serve_disagg_torch.py"),
         "--arch", ARCH, "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    rows = [l for l in out.stdout.splitlines() if "reused" in l]
    assert len(rows) == 4
    assert all(int(l.split("reused")[1].split()[0]) >= 96 for l in rows)
