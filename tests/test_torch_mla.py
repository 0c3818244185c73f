"""The port's MLA slice (deepseek-v3: multi-head latent attention over a
latent cache, a dense first layer then routed top-k experts with a shared
one, and the MTP head carried) held against the JAX package on the same
numpy inputs and the same float32 weights, converted from the JAX
``Model.init`` tree: ``mla_apply``'s three modes, decode at distinct
per-sequence positions against JAX run one sequence at a time, the smoke
model's logits and caches, greedy ``DecodeBatch`` tokens, every
``ServeResult`` field of both ``DisaggServer``s on a stream whose
follow-ups resume paged latents, the conversion of the MTP leaves and the
refusal of an int8 cache."""
import dataclasses

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

ARCH = "deepseek-v3-671b"
TOL = 2e-4          # float32 through the model, as tests/test_torch_moe.py
MLA_TOL = 1e-5      # one MLA layer in float32, as tests/test_models.py


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _models(cfg=None, seed=0):
    jcfg = cfg or JSMOKES[ARCH]
    jm = dataclasses.replace(jbuild(jcfg), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(cfg or SMOKES[ARCH], device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _models()


def _mla_layer(pair, si=1, c=0):
    """The MLA mixer of block ``c`` of segment ``si`` in both models."""
    jm, params, tm = pair
    jp = jax.tree.map(lambda a: a[c], params[f"seg{si}"][0]["mix"])
    return jp, getattr(tm, f"seg{si}")[c][0].mix


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


def _latents(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"c": rng.normal(size=(B, S, cfg.kv_lora_rank)).astype(np.float32),
            "kr": rng.normal(size=(B, S, cfg.rope_head_dim)
                             ).astype(np.float32)}


def _both(cache):
    return ({k: jnp.asarray(v) for k, v in cache.items()},
            {k: torch.from_numpy(v.copy()) for k, v in cache.items()})


# --------------------------------------------------------------- the layer
@pytest.mark.parametrize("mode", ["prefill", "suffix", "decode"])
def test_mla_apply_modes_match_jax(pair, mode):
    """Full prefill (the cache is the normed latent and the roped key),
    suffix prefill over a reused 12-position latent prefix at pos 12, and
    decode at one position for the batch."""
    jp, tp = _mla_layer(pair)
    cfg, jcfg = SMOKES[ARCH], JSMOKES[ARCH]
    T = 1 if mode == "decode" else 9
    x = _x(cfg, (2, T), 1)
    jc = tc = None
    pos = 0
    if mode == "suffix":
        jc, tc = _both(_latents(cfg, 2, 12, 2))
        pos = 12
    elif mode == "decode":
        jc, tc = _both(_latents(cfg, 2, 16, 2))
        pos = 11
    jy, jnew = jblocks.mla_apply(jp, jnp.asarray(x), cfg=jcfg, ctx=ShardCtx(),
                                 mode="decode" if mode == "decode"
                                 else "prefill", cache=jc, pos=pos)
    ty, tnew = blocks.mla_apply(
        tp, torch.from_numpy(x), cfg=cfg,
        mode="decode" if mode == "decode" else "prefill", cache=tc,
        pos=torch.full((2,), pos) if mode == "decode" else pos)
    assert ty.shape == jy.shape == (2, T, cfg.d_model)
    _close(ty, jy, MLA_TOL)
    assert tnew.keys() == jnew.keys() == {"c", "kr"}
    for k in tnew:
        assert tuple(tnew[k].shape) == jnew[k].shape
        _close(tnew[k], jnew[k], MLA_TOL)
    if mode == "suffix":                    # new caches, the prefix kept
        assert tnew["c"].data_ptr() != tc["c"].data_ptr()
        _close(tc["c"], _latents(cfg, 2, 12, 2)["c"], 0.0)


def test_mla_decode_at_per_row_positions_matches_jax_row_by_row(pair):
    """The port decodes a batch with one position a row ([B] tensor): each
    row's latent and key written at its own slot, its keys past its own
    position masked. JAX decodes one row at a time with a scalar position
    (its DecodeBatch vmaps over rows). The last row sits past the capacity:
    its write clamps to the last slot and it attends to every slot, as
    JAX's ``dynamic_update_slice`` and mask do."""
    jp, tp = _mla_layer(pair, si=0)
    cfg, jcfg = SMOKES[ARCH], JSMOKES[ARCH]
    S, pos = 16, [3, 9, 0, 15, 18]
    B = len(pos)
    x = _x(cfg, (B, 1), 3)
    lat = _latents(cfg, B, S, 4)
    _, tc = _both(lat)
    ty, tnew = blocks.mla_apply(tp, torch.from_numpy(x), cfg=cfg,
                                mode="decode", cache=tc,
                                pos=torch.tensor(pos))
    assert tnew["c"] is tc["c"]                           # in place
    for b, p in enumerate(pos):
        jc = {k: jnp.asarray(v[b:b + 1]) for k, v in lat.items()}
        jy, jnew = jblocks.mla_apply(jp, jnp.asarray(x[b:b + 1]), cfg=jcfg,
                                     ctx=ShardCtx(), mode="decode", cache=jc,
                                     pos=p)
        _close(ty[b:b + 1], jy, MLA_TOL)
        for k in ("c", "kr"):
            _close(tnew[k][b:b + 1], jnew[k], MLA_TOL)
    # rows do not see each other's writes: a row alone gives the same
    _, solo = _both({k: v[1:2] for k, v in lat.items()})
    y1, _ = blocks.mla_apply(tp, torch.from_numpy(x[1:2]), cfg=cfg,
                             mode="decode", cache=solo,
                             pos=torch.tensor([pos[1]]))
    _close(y1, ty[1:2], 1e-6)


# -------------------------------------------------------------------- model
def _caches_close(tc, jc, tol=TOL):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        t = tc
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(t.shape) == leaf.shape and \
            str(t.dtype)[6:] == str(leaf.dtype), path
        _close(t, leaf, tol)


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
    assert [sorted(l["mix"]) for s in tc for l in s] == [["c", "kr"]] * 2
    assert not cache_has_state(tc)                   # latents page


def test_suffix_prefill_over_a_reused_prefix_matches_jax(pair):
    """tests/test_models.py's semantics on the MLA smoke: a prefill resumed
    over the latents of the first P tokens equals the full prefill, in both
    packages, and builds new caches."""
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 2)
    P = 16
    _, jpre = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P],
                                                        jnp.int32)})
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, P:],
                                                       jnp.int32)},
                        caches=jpre, pos=P)
    _, tpre = tm.prefill({"tokens": toks[:, :P]})
    kept = tpre[1][0]["mix"]["c"].clone()
    tl, tc = tm.prefill({"tokens": toks[:, P:]}, caches=tpre, pos=P)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert torch.equal(tpre[1][0]["mix"]["c"], kept)
    full, _ = tm.prefill({"tokens": toks})
    _close(tl, full)


def test_decode_steps_match_jax(pair):
    """Decode into the prefill's latents padded to a capacity, 4 steps, as
    JAX's ``test_decode_consistent_with_prefill`` pairs prefill and
    decode."""
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 20, 3)
    n, cap = 16, 24
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                      jnp.int32)})
    _, tc = tm.prefill({"tokens": toks[:, :n]})
    jc = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, cap - n),
                                            (0, 0)]), jc)
    tc = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, cap - n))
                    for k, t in l["mix"].items()}} for l in s] for s in tc]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        _close(tl, jl)
    _caches_close(tc, jc)
    want, _ = tm.prefill({"tokens": toks})
    _close(tl, want)


def test_segment_of_no_blocks_matches_jax():
    """At ``n_layers == first_dense`` JAX plans an MoE segment of no blocks
    and its scan gives caches with a count axis of 0; the port's plan,
    logits and caches are the same, resumed by a suffix prefill too."""
    cfg = dataclasses.replace(SMOKES[ARCH], n_layers=1)
    jm, params, tm = _models(cfg)
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(s.count, s.kinds) for s in jm.segments] == \
        [(1, (("mla", False, 0),)), (0, (("mla", True, 0),))]
    toks = _tokens(cfg, 14, 5)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :10],
                                                       jnp.int32)})
    tl, tc = tm.prefill({"tokens": toks[:, :10]})
    _close(tl, jl)
    _caches_close(tc, jc)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, 10:],
                                                       jnp.int32)},
                        caches=jc, pos=10)
    tl, tc = tm.prefill({"tokens": toks[:, 10:]}, caches=tc, pos=10)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert tuple(tc[1][0]["mix"]["c"].shape) == (0, 1, 14, cfg.kv_lora_rank)


def test_init_and_cache_shapes_match_jax():
    """Names, shapes and dtypes of every parameter in bf16 (the MLA names,
    ``mtp_proj`` and the one-layer ``mtp_layer`` among them); the latent
    cache tree of ``init_cache``."""
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
        elif keys[0] == "mtp_layer":
            want[".".join([keys[0], "0"] + keys[1:])] = \
                (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {k: (tuple(v.shape), str(v.dtype)[6:])
           for k, v in tm.state_dict().items()}
    assert got == want
    for name in ("wq_a.w", "q_norm.g", "wq_b.w", "wkv_a.w", "kv_norm.g",
                 "wk_b.w", "wv_b.w", "wo.w"):
        assert f"seg0.0.0.mix.{name}" in got
    assert got["mtp_proj.w"] == ((256, 128), "bfloat16")
    assert "mtp_layer.0.ffn_moe.router" in got      # built as the last layer
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
    assert [[{k: (tuple(t.shape), str(t.dtype)[6:])
              for k, t in l["mix"].items()} for l in s] for s in tc] == \
        [[{k: (t.shape, str(t.dtype)) for k, t in l["mix"].items()}
          for l in s] for s in jc]


def test_conversion_is_strict_over_the_mla_and_mtp_leaves():
    jm = jbuild(JSMOKES[ARCH])
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKES[ARCH], device="cpu", dtype=torch.float32)
    from_jax_params(params, tm)
    _close(tm.mtp_layer[0].mix.wkv_a.w,
           params["mtp_layer"]["mix"]["wkv_a"]["w"][0], 0.0)
    _close(tm.mtp_proj.w, params["mtp_proj"]["w"], 0.0)
    _close(tm.seg1[1][0].mix.kv_norm.g, params["seg1"][0]["mix"]["kv_norm"]
           ["g"][1], 0.0)
    for drop in (("mtp_proj",), ("mtp_layer", "mix", "wk_b"),
                 ("seg0", 0, "mix", "q_norm")):
        bad = jax.tree.map(lambda a: a, params)
        node = bad
        for k in drop[:-1]:
            node = node[k]
        del node[drop[-1]]
        with pytest.raises(KeyError, match="missing"):
            from_jax_params(bad, build_model(SMOKES[ARCH], device="cpu"))
    bad = jax.tree.map(lambda a: a, params)
    bad["seg0"][0]["mix"]["wq"] = bad["seg0"][0]["mix"]["wq_a"]
    with pytest.raises(KeyError, match="unexpected"):
        from_jax_params(bad, build_model(SMOKES[ARCH], device="cpu"))


def test_int8_cache_is_refused_for_mla():
    """JAX's ``init_cache(kv_dtype=int8)`` stores the latent and the rope key
    as int8 and its MLA attends over the codes as values; the port
    raises."""
    tm = build_model(SMOKES[ARCH], device="cpu")
    with pytest.raises(ValueError, match="mla"):
        tm.init_cache(2, 32, kv_dtype=torch.int8)
    tm.init_cache(2, 32)


def test_full_width_depth_4_plan_and_parameter_count():
    """deepseek-v3 at full width cut to depth 4 (the three dense layers and
    one MoE layer, the MTP layer carried), as the card serves it."""
    cfg = dataclasses.replace(ARCHS[ARCH], n_layers=4)
    tm = build_model(cfg, device="meta")
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(3, (("mla", False, 0),)), (1, (("mla", True, 0),))]
    mla = tm.seg0[0][0].mix
    assert tuple(mla.wq_a.w.shape) == (7168, 1536)
    assert tuple(mla.wq_b.w.shape) == (1536, 128 * 192)
    assert tuple(mla.wkv_a.w.shape) == (7168, 512 + 64)
    assert tuple(mla.wk_b.w.shape) == (512, 128 * 128)
    assert tuple(tm.seg1[0][0].ffn_moe.w_in.shape) == (256, 7168, 2048)
    assert tm.mtp_layer[0].ffn_moe is not None
    n = sum(p.numel() for p in tm.parameters())
    mtp = sum(p.numel() for m in (tm.mtp_layer, tm.mtp_proj)
              for p in m.parameters())
    assert 26.72e9 < n < 26.73e9 and 11.61e9 < mtp < 11.62e9
    # cfg.params() counts every layer's two norms but not the final one,
    # nor MLA's q_norm and kv_norm, nor the MTP head
    assert n == cfg.params() + cfg.d_model + mtp + \
        cfg.n_layers * (cfg.q_lora_rank + cfg.kv_lora_rank)


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


def test_disagg_server_results_equal_jax_with_paged_latents(pair):
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
    assert set(srv.store._pools) == {(si, 0, "mix", n) for si in (0, 1)
                                     for n in ("c", "kr")}


def test_launcher_serves_the_mla_smoke_on_cpu():
    summary = run(ARCH, device="cpu", n_requests=6, policies=("mfs",),
                  verbose=False)
    assert 0.0 <= summary["mfs"]["slo_attainment"] <= 1.0
