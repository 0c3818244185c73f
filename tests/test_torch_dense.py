"""The rest of the dense family held against the JAX model: the qwen1.5-32b,
minitron-8b and starcoder2-3b smokes, the same float32 weights in both
packages (the JAX ``Model.init`` pytree through ``from_jax_params``; qwen's
zero-initialised q/k/v biases given values), the same tokens: full prefill,
suffix prefill at pos=16 and four decode steps give the same logits and
caches. The layouts they force: qwen's MHA with 4 heads padded to 16 (query
and KV heads pad together in the parameters, a cache from ``init_cache``
keeps the 4 real KV heads), minitron's 8 -> 2 and starcoder2's 6 -> 2 GQA
padded to 16 query heads, whose last KV head serves the padded no-op heads
too (starcoder2-3b at full width: 24 heads padded to 32 over 2 KV heads)."""
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
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import DisaggServer as JDisaggServer
from repro.serving import ServeRequest as JServeRequest
from repro.simcluster.hw import A100 as JA100
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.launch.serve import make_requests, run
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.blocks import AttnDims
from repro_torch.serving import DisaggConfig, DisaggServer, ServeRequest
from repro_torch.simcluster.hw import A100

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4          # float32 through 2-layer models, as test_torch_models.py
NAMES = ("qwen1.5-32b", "minitron-8b", "starcoder2-3b")


def _models(name):
    jm = dataclasses.replace(jbuild(JSMOKES[name]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    if SMOKES[name].qkv_bias:       # JAX inits biases to 0: give them values
        rng = np.random.default_rng(11)
        for w in ("wq", "wk", "wv"):
            b = params["seg0"][0]["mix"][w]["b"]
            params["seg0"][0]["mix"][w]["b"] = jnp.asarray(
                rng.normal(size=b.shape) * 0.1, jnp.float32)
    tm = build_model(SMOKES[name], device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return (request.param,) + _models(request.param)


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _caches_close(tc, jc):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        t = tc
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(t.shape) == leaf.shape, path
        _close(t, leaf)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(1, n))


def _grow(tc, jc, n):
    """Both packages' caches padded by ``n`` empty slots."""
    jc = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, n), (0, 0),
                                            (0, 0)]), jc)
    tc = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
                    for k, t in layer["mix"].items()}} for layer in seg]
          for seg in tc]
    return tc, jc


def test_full_prefill_matches_jax(pair):
    _, jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill({"tokens": toks})
    assert tl.shape == jl.shape == (1, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)


def test_prefill_sink_hands_over_each_layers_cache(pair):
    """``Model.prefill`` with a sink (what a 32k prompt is stored through,
    layer by layer, into a decode cache): the same logits, every layer's
    cache handed over once, in the order the layers run, equal to that
    layer's entry of the stacked caches, and no caches returned."""
    _, _, _, tm = pair
    toks = _tokens(tm.cfg, 24, 1)
    tl, tc = tm.prefill({"tokens": toks})
    got = []
    sl, none = tm.prefill({"tokens": toks},
                          sink=lambda si, i, c, nc: got.append((si, i, c, nc)))
    assert none is None
    assert torch.equal(sl, tl)
    assert [g[:3] for g in got] == [
        (si, i, c) for si, seg in enumerate(tm.segments)
        for c in range(seg.count) for i in range(len(seg.kinds))]
    for si, i, c, nc in got:
        assert nc.keys() == tc[si][i]["mix"].keys()
        for name, t in nc.items():
            assert torch.equal(t, tc[si][i]["mix"][name][c])


def test_suffix_prefill_matches_jax(pair):
    _, jm, params, tm = pair
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
    full, _ = tm.prefill({"tokens": toks})          # reuse is exact
    _close(tl, full)


def test_decode_steps_match_jax(pair):
    """Four decode steps after a 16-token prefill, caches grown to 24."""
    _, jm, params, tm = pair
    toks = _tokens(tm.cfg, 20, 3)
    n = 16
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                      jnp.int32)})
    _, tc = tm.prefill({"tokens": toks[:, :n]})
    tc, jc = _grow(tc, jc, 8)
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        _close(tl, jl)
    _caches_close(tc, jc)


def test_decode_over_init_cache_heads_matches_jax(pair):
    """Decode into caches laid out as ``init_cache`` lays them (the real KV
    heads only: for qwen's padded MHA 4 of the 16 the prefill keeps), the
    prefill's real heads copied in: the padded heads' K/V are cropped on
    insert and the map sends the padded query heads to the last real KV
    head, in both packages."""
    name, jm, params, tm = pair
    toks = _tokens(tm.cfg, 14, 5)
    n, cap = 10, 16
    _, jpre = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                        jnp.int32)})
    _, tpre = tm.prefill({"tokens": toks[:, :n]})
    jc = jm.init_cache(1, cap, kv_dtype=jnp.float32)
    tc = tm.init_cache(1, cap)
    kv = tm.cfg.n_kv
    jc = jax.tree.map(lambda z, p: z.at[:, :, :n].set(p[:, :, :, :kv]),
                      jc, jpre)
    for seg_t, seg_p in zip(tc, tpre):
        for lt, lp in zip(seg_t, seg_p):
            for k in ("k", "v"):
                assert lt["mix"][k].shape[3] == kv
                lt["mix"][k][:, :, :n] = lp["mix"][k][:, :, :, :kv]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        _close(tl, jl)
    _caches_close(tc, jc)


def test_init_cache_matches_jax(pair):
    """The same leaves, shapes and dtypes, int8 K/V included."""
    _, jm, _, tm = pair
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        tc = tm.init_cache(3, 10, kv_dtype=tdt)
        jc = jm.init_cache(3, 10, kv_dtype=jdt)
        got = [[{k: (tuple(t.shape), str(t.dtype).split(".")[1])
                 for k, t in l["mix"].items()} for l in s] for s in tc]
        want = [[{k: (t.shape, str(t.dtype)) for k, t in l["mix"].items()}
                 for l in s] for s in jc]
        assert got == want


@pytest.mark.parametrize("name,n_q,n_kv,groups", [
    ("qwen1.5-32b", 48, 48, None),
    ("minitron-8b", 32, 8, [4] * 8),
    ("starcoder2-3b", 32, 2, [12, 20])])
def test_full_width_head_layouts(name, n_q, n_kv, groups):
    """The padded layouts at full width: qwen pads 40 MHA heads to 48 in
    the parameters and keeps the 40 real KV heads in ``init_cache``;
    starcoder2's second KV head serves 20 query heads, 8 of them padded."""
    cfg = ARCHS[name]
    dims = AttnDims.of(cfg)
    assert (dims.n_q, dims.n_kv, dims.hd) == (n_q, n_kv, 128)
    kv_map = dims.q_to_kv(cfg).clamp(max=cfg.n_kv - 1)
    if groups is not None:
        assert torch.bincount(kv_map).tolist() == groups
    else:
        assert kv_map.tolist() == list(range(40)) + [39] * 8
    model = build_model(cfg, device="meta")
    assert model.seg0[0][0].mix.wk.w.shape == (cfg.d_model, n_kv * 128)
    cache = model.init_cache(1, 4, kv_dtype=torch.int8)
    assert cache[0][0]["mix"]["k"].shape == (cfg.n_layers, 1, 4, cfg.n_kv,
                                             128)
    assert cache[0][0]["mix"]["k"].dtype == torch.int8


def _requests(cfg, req_cls):
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, size=(32,))
    return [req_cls(rid=i, arrival=i * 1e-4, max_new=3, tokens=(
        np.concatenate([shared, rng.integers(0, cfg.vocab, size=(10,))])
        if i % 2 == 0 else rng.integers(0, cfg.vocab, size=(40,))))
        for i in range(6)]


def test_disagg_server_results_equal_jax(pair):
    """Every ``ServeResult`` field equals JAX's on a stream with prefix hits
    (suffix prefills over paged K/V, batched decode)."""
    _, jm, params, tm = pair
    kw = dict(n_prefill_units=2, n_pages=128)
    got = DisaggServer(tm, cfg=DisaggConfig(hw=A100, **kw)).serve(
        _requests(tm.cfg, ServeRequest))
    want = JDisaggServer(jm, params, cfg=JDisaggConfig(hw=JA100, **kw)).serve(
        _requests(tm.cfg, JServeRequest))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert any(r.reused_tokens >= 32 for r in got)


class _FullConfig:
    """A smoke model that tells ``DisaggServer`` the full config's shapes:
    the modeled clock (routing, prefix registration, TTFT) reads only
    ``cfg``, while prefill and decode run the smoke, on tokens folded into
    its vocabulary."""

    def __init__(self, cfg, smoke):
        self.cfg, self._smoke = cfg, smoke

    def __getattr__(self, name):
        return getattr(self._smoke, name)

    def prefill(self, batch, **kw):
        toks = torch.as_tensor(batch["tokens"]) % self._smoke.cfg.vocab
        return self._smoke.prefill({**batch, "tokens": toks}, **kw)


@pytest.mark.parametrize("name,rps", [("minitron-8b", 100.0),
                                      ("starcoder2-3b", 200.0)])
def test_serve_phase_streams_resume_a_prefix(name, rps):
    """The streams the card's full-width serve phases run (16 requests,
    half on 4 Zipf-hot 32-token prefixes, at ``rps``): on the modeled clock
    of the full config a follow-up is routed after its prefix registered,
    so a suffix prefill runs over a reused 32-token paged prefix."""
    smoke = build_model(SMOKES[name], device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    reqs = make_requests(ARCHS[name], 16, rps, seed=0, mean_prompt=256,
                         max_new=8)
    res = DisaggServer(_FullConfig(ARCHS[name], smoke), cfg=DisaggConfig(
        n_prefill_units=2, decode_slots=8, decode_capacity=1024)).serve(
            reqs, decode_steps=1)
    assert any(r.reused_tokens >= 32 for r in res)


@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves_the_smoke_on_cpu_when_asked(name):
    summary = run(name, device="cpu", n_requests=4, policies=("mfs",),
                  verbose=False)
    assert 0.0 <= summary["mfs"]["slo_attainment"] <= 1.0
    assert summary["mfs"]["mean_ttft_ms"] > 0.0


def test_example_serves_the_starcoder2_smoke_on_cpu_with_reuse():
    """The agent stream's follow-ups resume the warm prompts' pages."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/serve_disagg_torch.py"),
         "--arch", "starcoder2-3b", "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    rows = [l for l in out.stdout.splitlines() if "reused" in l]
    assert len(rows) == 4
    assert all(int(l.split("reused")[1].split()[0]) >= 96 for l in rows)
