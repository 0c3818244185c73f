"""int8 KV in the port held against the JAX package: ``_kv_store`` gives the
JAX model's codes, a decode step over an int8 cache gives JAX's logits and
codes, the JAX test's int8-vs-bf16 criterion holds on the port, the plain
decode attention over codes is the oracle over their values, the two
divergences of the JAX model are refused (a suffix prefill over an int8
cache, an int8 cache for SSM or RG-LRU layers), and ``DisaggServer`` with
``kv_dtype_bytes=1`` gives JAX's ``ServeResult``s."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SMOKES as JSMOKES
from repro.kernels import ref as jref
from repro.models.blocks import _kv_store as jkv_store
from repro.models.lm import build_model as jbuild
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import DisaggServer as JDisaggServer
from repro.serving import ServeRequest as JServeRequest
from repro.simcluster.hw import A100 as JA100
from repro_torch.configs import SMOKES
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.blocks import _KV_QSCALE, _kv_load, _kv_store
from repro_torch.serving import DisaggConfig, DisaggServer, ServeRequest
from repro_torch.simcluster.hw import A100

TOL = 2e-4          # float32 through 2-layer models, as test_torch_models.py
QWEN = "qwen1.5-32b"


@pytest.fixture(scope="module")
def qwen():
    """The qwen1.5 smoke (4 MHA heads padded to 16, q/k/v biases given
    values) in float32 in both packages."""
    jm = dataclasses.replace(jbuild(JSMOKES[QWEN]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    for w in ("wq", "wk", "wv"):
        b = params["seg0"][0]["mix"][w]["b"]
        params["seg0"][0]["mix"][w]["b"] = jnp.asarray(
            rng.normal(size=b.shape) * 0.1, jnp.float32)
    tm = build_model(SMOKES[QWEN], device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_store_codes_equal_jax(dtype):
    """Code for code: ties at .5 round half to even in both, the clip is
    +/-127, and the load is code / 32."""
    rng = np.random.default_rng(0)
    ties = (np.arange(-40, 41) + 0.5) / _KV_QSCALE            # k + 0.5 codes
    x = np.concatenate([rng.normal(size=4000) * 2.0, ties,
                        [5.0, -5.0, 3.97, -3.97, 127.5 / 32, -127.5 / 32,
                         0.0, -0.0]]).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = _kv_store(tx, torch.int8)
    want = np.asarray(jkv_store(jx, jnp.int8))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == -127 and got.max() == 127
    if dtype == "float32":   # the ties are exact in float32: half to even
        t = got[4000:4000 + ties.size].numpy()
        np.testing.assert_array_equal(t % 2, 0)
    np.testing.assert_array_equal(
        _np(_kv_load(got, torch.float32)), want.astype(np.float32) / 32)
    assert torch.equal(_kv_load(tx, torch.float32), tx)     # not int8: as is


def _int8_caches(jm, params, tm, toks, n, cap):
    """Both packages' prefill caches of ``toks[:, :n]`` stored as int8 codes
    in caches laid out as ``init_cache`` lays them (the real KV heads)."""
    kv = tm.cfg.n_kv
    _, jpre = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                        jnp.int32)})
    _, tpre = tm.prefill({"tokens": toks[:, :n]})
    jc = jax.tree.map(
        lambda z, p: z.at[:, :, :n].set(jkv_store(p[:, :, :, :kv], jnp.int8)),
        jm.init_cache(1, cap, kv_dtype=jnp.int8), jpre)
    tc = tm.init_cache(1, cap, kv_dtype=torch.int8)
    for seg_t, seg_p in zip(tc, tpre):
        for lt, lp in zip(seg_t, seg_p):
            for k in ("k", "v"):
                lt["mix"][k][:, :, :n] = _kv_store(
                    lp["mix"][k][:, :, :, :kv], torch.int8)
    return tc, jc


def test_decode_over_int8_cache_equals_jax(qwen):
    """Four decode steps over an int8 cache: the same logits, and the codes
    decode writes equal JAX's (the cache leaves stay int8)."""
    jm, params, tm = qwen
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab, size=(1, 16))
    n = 12
    tc, jc = _int8_caches(jm, params, tm, toks, n, 16)
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=TOL)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        t = tc
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert t.dtype == torch.int8 and leaf.dtype == jnp.int8
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_int8_kv_decode_close_to_bf16():
    """``tests/test_models.py::test_int8_kv_decode_close_to_bf16`` on the
    port: the qwen1.5 smoke in bf16 (the JAX weights of its PRNGKey(0)),
    an 8-token prefill, caches grown to 16 slots; one decode step over the
    bf16 cache and over its int8 codes differ by a total-variation
    distance under 0.25 and agree on the argmax."""
    jm = jbuild(JSMOKES[QWEN])
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(SMOKES[QWEN], device="cpu", dtype=torch.bfloat16)
    from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 params), tm)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab, size=(1, 8))
    _, cache = tm.prefill({"tokens": toks})
    bf16 = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 8))
                      for k, t in l["mix"].items()}} for l in s]
            for s in cache]
    int8 = [[{"mix": {k: _kv_store(t, torch.int8)
                      for k, t in l["mix"].items()}} for l in s]
            for s in bf16]
    tok = toks[:, -1:]
    lg_a, _ = tm.decode_step(bf16, tok, 8)
    lg_b, _ = tm.decode_step(int8, tok, 8)
    a = torch.softmax(lg_a.float()[0, -1], -1)
    b = torch.softmax(lg_b.float()[0, -1], -1)
    assert float((a - b).abs().sum()) < 0.25
    assert int(a.argmax()) == int(b.argmax())


@pytest.mark.parametrize("H,Hk,rep,dtype", [(6, 5, 1, torch.float32),
                                             (32, 2, 12, torch.float32),
                                             (6, 5, 1, torch.bfloat16)])
def test_plain_decode_over_codes_is_the_oracle_over_values(H, Hk, rep, dtype):
    """int8 K/V through the plain version equal the JAX oracle over their
    dequantised values, expanded through the map ``min(h // rep, Hk - 1)``
    (6 query heads over 5 KV heads: the last serves 2, as qwen's 48 over
    40; starcoder2-3b's 32 over 2 in groups of 12 and 20), lengths 0, 1,
    full and ragged."""
    rng = np.random.default_rng(H + Hk)
    B, S, D = 4, 37, 32
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kc, vc = (rng.integers(-127, 128, size=(B, S, Hk, D)).astype(np.int8)
              for _ in range(2))
    kv_map = np.minimum(np.arange(H) // rep, Hk - 1).astype(np.int32)
    lengths = np.array([0, 1, S, 20], np.int32)
    tq = torch.from_numpy(q).to(dtype)
    got = decode_attention(tq, torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.from_numpy(lengths),
                           kv_map=torch.from_numpy(kv_map),
                           kv_scale=1 / _KV_QSCALE)
    assert got.dtype == dtype
    kx, vx = ((c.astype(np.float32) / 32)[:, :, kv_map] for c in (kc, vc))
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(_np(tq)), jnp.asarray(kx), jnp.asarray(vx),
        jnp.asarray(lengths)))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    # rows of length > 0 (the JAX oracle averages V over a row with none)
    np.testing.assert_allclose(_np(got)[1:], want[1:], atol=tol, rtol=tol)
    assert torch.all(got[0] == 0)
    with pytest.raises(ValueError):          # codes need their scale
        decode_attention_plain(tq, torch.from_numpy(kc),
                               torch.from_numpy(vc),
                               torch.from_numpy(lengths),
                               kv_map=torch.from_numpy(kv_map))
    with pytest.raises(ValueError):          # and only codes take one
        decode_attention_plain(tq, torch.from_numpy(kx), torch.from_numpy(vx),
                               torch.from_numpy(lengths), kv_scale=1 / 32)


def test_suffix_prefill_over_int8_cache_raises(qwen):
    """The JAX model concatenates int8 codes with the new keys unscaled
    (``jnp.concatenate([int8 64, bf16 1.0])`` is ``[64, 1]``, not
    ``[2, 1]``); the port refuses."""
    _, _, tm = qwen
    toks = np.arange(12)[None] % tm.cfg.vocab
    _, cache = tm.prefill({"tokens": toks[:, :8]})
    codes = [[{"mix": {k: _kv_store(t, torch.int8)
                       for k, t in l["mix"].items()}} for l in s]
             for s in cache]
    with pytest.raises(ValueError, match="int8"):
        tm.prefill({"tokens": toks[:, 8:]}, caches=codes, pos=8)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_int8_cache_for_ssm_or_rglru_layers_raises(name):
    """The JAX model's ``init_cache`` stores their conv windows as int8 and
    its blocks concatenate them unscaled; the port refuses."""
    tm = build_model(SMOKES[name], device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="int8"):
        tm.init_cache(1, 8, kv_dtype=torch.int8)
    tm.init_cache(1, 8)                      # the default still builds


def _requests(cfg, req_cls):
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, size=(32,))
    return [req_cls(rid=i, arrival=i * 1e-4, max_new=3, tokens=(
        np.concatenate([shared, rng.integers(0, cfg.vocab, size=(10,))])
        if i % 2 == 0 else rng.integers(0, cfg.vocab, size=(40,))))
        for i in range(6)]


def test_disagg_server_int8_kv_bytes_results_equal_jax(qwen):
    """``kv_dtype_bytes=1`` halves the K/V bytes the modeled clock moves
    (Stage-1 and P2D flows, the decode roofline): every ``ServeResult``
    field equals JAX's on the qwen1.5 smoke, with prefix hits."""
    jm, params, tm = qwen
    kw = dict(n_prefill_units=2, n_pages=128, kv_dtype_bytes=1)
    got = DisaggServer(tm, cfg=DisaggConfig(hw=A100, **kw)).serve(
        _requests(tm.cfg, ServeRequest))
    want = JDisaggServer(jm, params, cfg=JDisaggConfig(hw=JA100, **kw)).serve(
        _requests(tm.cfg, JServeRequest))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert any(r.reused_tokens >= 32 for r in got)
    base = DisaggServer(tm, cfg=DisaggConfig(
        hw=A100, **{**kw, "kv_dtype_bytes": 2})).serve(
        _requests(tm.cfg, ServeRequest))
    assert [r.ttft for r in got] != [r.ttft for r in base]
