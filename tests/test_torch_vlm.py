"""The port's VLM backbone (qwen2-vl-7b: the dense GQA decoder with q/k/v
bias, entered through input embeddings from the stubbed vision frontend or
through text tokens) held against the JAX package on the same numpy inputs
and the same float32 weights, converted from the JAX ``Model.init`` tree:
a prefill from ``inputs_embeds`` (logits and caches), a suffix prefill over
it, decode steps fed embeddings and tokens, greedy ``DecodeBatch`` tokens
and every ``ServeResult`` field of both ``DisaggServer``s on text
requests with prefix hits. Its full width pads 28 query heads to 32 over 4
KV heads, the uneven map the kernels take."""
import dataclasses

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
from repro_torch.launch.serve import run
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.blocks import AttnDims
from repro_torch.serving import (DecodeBatch, DisaggConfig, DisaggServer,
                                 ServeRequest, ServingEngine)
from repro_torch.simcluster.hw import A100

ARCH = "qwen2-vl-7b"
TOL = 2e-4          # float32 through the model, as tests/test_torch_dense.py


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


def _embeds(cfg, shape, seed):
    """Patch embeddings of the stub frontend's scale: N(0, 1/d)."""
    return (np.random.default_rng(seed).normal(size=shape + (cfg.d_model,))
            / np.sqrt(cfg.d_model)).astype(np.float32)


def test_inputs_embeds_prefill_matches_jax(pair):
    """JAX's ``_embed`` takes ``inputs_embeds`` in place of tokens; both
    packages give the same logits and caches from the same embeddings (1-D
    rope over their positions: JAX's ``mrope_positions`` is not called)."""
    jm, params, tm = pair
    emb = _embeds(tm.cfg, (2, 19), 1)
    jl, jc = jm.prefill(params, {"inputs_embeds": jnp.asarray(emb)})
    tl, tc = tm.prefill({"inputs_embeds": emb})
    assert tl.shape == jl.shape == (2, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)


def test_suffix_prefill_over_an_embedded_prefix_matches_jax(pair):
    """Text tokens after a prefix entered as embeddings (an image then its
    prompt), over the prefix's cache at pos P, in both packages."""
    jm, params, tm = pair
    P = 12
    emb = _embeds(tm.cfg, (1, P), 2)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, size=(1, 7))
    _, jpre = jm.prefill(params, {"inputs_embeds": jnp.asarray(emb)})
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                        caches=jpre, pos=P)
    _, tpre = tm.prefill({"inputs_embeds": emb})
    tl, tc = tm.prefill({"tokens": toks}, caches=tpre, pos=P)
    _close(tl, jl)
    _caches_close(tc, jc)
    # the same as one prefill of the prefix's embeddings and the tokens'
    full = np.concatenate([emb, tm.embed[torch.from_numpy(toks)].numpy()], 1)
    want, _ = tm.prefill({"inputs_embeds": full})
    _close(tl, want)


@pytest.mark.parametrize("feed", ["embeds", "tokens"])
def test_decode_steps_match_jax(pair, feed):
    """Decode fed [B, 1, d] embeddings (JAX's ``decode_step`` takes a float
    ``tok`` as embeddings) or [B, 1] tokens, after a prefill from
    embeddings padded to a capacity."""
    jm, params, tm = pair
    n, cap, B = 10, 16, 2
    emb = _embeds(tm.cfg, (B, n + 3), 3)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab, size=(B, 3))
    _, jc = jm.prefill(params, {"inputs_embeds": jnp.asarray(emb[:, :n])})
    _, tc = tm.prefill({"inputs_embeds": emb[:, :n]})
    pad = [(0, 0), (0, 0), (0, cap - n), (0, 0), (0, 0)]
    jc = jax.tree.map(lambda a: jnp.pad(a, pad), jc)
    tc = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cap - n))
                    for k, t in l["mix"].items()}} for l in s] for s in tc]
    for step in range(3):
        if feed == "embeds":
            tok = emb[:, n + step:n + step + 1]
            jtok = jnp.asarray(tok)
        else:
            tok = toks[:, step:step + 1]
            jtok = jnp.asarray(tok, jnp.int32)
        jl, jc = jm.decode_step(params, jc, jtok, n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        assert tl.shape == (B, 1, tm.vocab_padded)
        _close(tl, jl)
    _caches_close(tc, jc)


def test_full_width_head_map_and_parameter_count():
    """28 query heads padded to 32 over 4 KV heads: groups of 7, the last
    KV head serving 11 (4 of them padded no-ops); 28 layers, 7.718 B
    parameters with the padding."""
    cfg = ARCHS[ARCH]
    dims = AttnDims.of(cfg)
    assert (dims.n_q, dims.n_kv, dims.hd) == (32, 4, 128)
    assert dims.q_to_kv(cfg).tolist() == [h // 7 for h in range(21)] + \
        [3] * 11
    tm = build_model(cfg, device="meta")
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(28, (("attn", False, 0),))]
    assert tm.seg0[0][0].mix.wq.b is not None                # q/k/v bias
    n = sum(p.numel() for p in tm.parameters())
    assert 7.71e9 < n < 7.72e9


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


def test_launcher_serves_the_vlm_smoke_on_cpu():
    summary = run(ARCH, device="cpu", n_requests=6, policies=("mfs",),
                  verbose=False)
    assert 0.0 <= summary["mfs"]["slo_attainment"] <= 1.0
