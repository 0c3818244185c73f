"""The port's Mamba2 (SSD) slice held against the JAX package on the same
numpy inputs: the SSD oracles against ``repro.kernels.ref`` and the Pallas
``ssd_chunked`` in interpret mode, the mamba2 smoke model (prefill, suffix
prefill, decode; logits and caches) through ``from_jax_params``, greedy
``DecodeBatch`` tokens, every ``ServeResult`` field of both
``DisaggServer``s on a stream that resumes snapshots, and the snapshot
regime of the prefix index on a real port cache."""
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
from repro.kernels.ssd_scan import ssd_chunked as jssd_chunked
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
from repro_torch.kernels.ssd_scan import (SSD_REC_MAX_T, _rows16,
                                          ssd_chunked, ssd_chunked_plain,
                                          ssd_cost, ssd_plan)
from repro_torch.launch.serve import agent_requests, run
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (DecodeBatch, DisaggConfig, DisaggServer,
                                 PagedStore, PrefixIndex, ServeRequest,
                                 ServingEngine, cache_has_state)
from repro_torch.serving.paged_kv import cache_bytes, tree_leaves_with_path
from repro_torch.simcluster.hw import A100

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4          # float32 through 2-layer models, summation order differs
KTOL = 1e-4         # the SSD kernels' tolerance, as tests/test_kernels.py
ARCH = "mamba2-1.3b"


# ------------------------------------------------------------------ oracles
def _ssd_inputs(Bz, T, H, hd, N, with_init, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bz, T, H, hd)).astype(np.float32)
    B = (rng.normal(size=(Bz, T, N)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(Bz, T, N)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(Bz, T, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    s0 = (rng.normal(size=(Bz, H, hd, N)).astype(np.float32)
          if with_init else None)
    return x, B, C, dt, A, D, s0


def _t(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


SHAPES = [(2, 64, 4, 64, 32, 32), (1, 100, 2, 64, 128, 32),   # ragged T
          (2, 256, 8, 64, 64, 128), (1, 32, 2, 128, 64, 16)]


@pytest.mark.parametrize("Bz,T,H,hd,N,chunk", SHAPES)
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_oracles_match_jax_and_pallas_interpret(Bz, T, H, hd, N, chunk,
                                                    with_init):
    arrs = _ssd_inputs(Bz, T, H, hd, N, with_init)
    x, B, C, dt, A, D, s0 = _j(arrs)
    jy, js = jref.ssd_ref(x, B, C, dt, A, D, init_state=s0)
    py, ps = jssd_chunked(x, B, C, dt, A, D, init_state=s0, chunk=chunk,
                          interpret=True)
    targs = _t(arrs)
    for fn in (tref.ssd_ref,
               lambda *a: tref.ssd_dual(*a, chunk=chunk),
               ssd_chunked, tops.ssd):
        ty, ts = fn(*targs[:6], targs[6])
        for want_y, want_s in ((jy, js), (py, ps)):
            _close(ty, want_y, KTOL)
            _close(ts, want_s, KTOL)


def test_ssd_dual_matches_jax_dual_chunk_for_chunk():
    arrs = _ssd_inputs(1, 100, 2, 32, 16, True, seed=1)
    for chunk in (16, 32, 128):
        jy, js = jref.ssd_dual(*_j(arrs), chunk=chunk)
        ty, ts = tref.ssd_dual(*_t(arrs), chunk=chunk)
        _close(ty, jy, 1e-5)
        _close(ts, js, 1e-5)


@pytest.mark.parametrize("T", [1, 16, 17])
def test_ops_ssd_dispatch_mirrors_jax(T):
    """On the CPU: the dual form above 16 steps, the recurrence otherwise."""
    arrs = _t(_ssd_inputs(2, T, 2, 32, 16, True, seed=T))
    want = (tref.ssd_dual if T > 16 else tref.ssd_ref)(*arrs)
    got = tops.ssd(*arrs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_state_chains_across_calls():
    """Splitting a sequence across two calls == one long call."""
    arrs = _t(_ssd_inputs(1, 64, 2, 64, 32, False, seed=2))
    x, B, C, dt, A, D, _ = arrs
    y, s = ssd_chunked(x, B, C, dt, A, D)
    h = 32
    y1, s1 = ssd_chunked(x[:, :h], B[:, :h], C[:, :h], dt[:, :h], A, D)
    y2, s2 = ssd_chunked(x[:, h:], B[:, h:], C[:, h:], dt[:, h:], A, D,
                         init_state=s1)
    _close(torch.cat([y1, y2], 1), y, KTOL)
    _close(s2, s, KTOL)
    assert ssd_chunked_plain is tref.ssd_dual


def test_ssd_chunked_has_no_kernel_off_cuda():
    """On neither the CPU nor the card nor meta (``_off_card``)."""
    x, B, C, dt, A, D, _ = (off_card(t) if t is not None else None
                            for t in _t(_ssd_inputs(1, 4, 2, 32, 16, False)))
    with pytest.raises(ValueError, match="no kernel"):
        ssd_chunked(x, B, C, dt, A, D)


def test_rows16_copies_only_what_the_kernel_cannot_read():
    """B and C rows must be dense and start on 16 bytes: the model's slices
    of the conv output are, a misaligned view gets an aligned copy."""
    conv_out = torch.zeros(1, 8, 4096 + 2 * 128)
    B = conv_out[..., 4096:4096 + 128]
    assert _rows16(B) is B
    odd = torch.zeros(1, 8, 129)[..., 1:]
    got = _rows16(odd)
    assert got is not odd and got.is_contiguous() and torch.equal(got, odd)


def test_ssd_cost_at_the_serve_shapes():
    flops, nbytes = ssd_cost(1, 256, 64, 64, 128, with_init=False)
    assert flops == 4 * 256 * 64 * 64 * 128                 # 0.54 GFLOP
    assert 10.5e6 < nbytes < 11e6
    _, dec = ssd_cost(8, 1, 64, 64, 128)
    assert 2 * 8 * 64 * 64 * 128 * 4 < dec < 34e6           # state in + out


@pytest.mark.parametrize("Bz,T,H,hd,N,want", [
    # mamba2-1.3b: prefill, fresh prompt, either side of the threshold
    # (the suffix is 32 steps), decode
    (1, 256, 64, 64, 128, ("dual", 64, 32, 640, 128, 208896, 4 * 64 * 64)),
    (1, 288, 64, 64, 128, ("dual", 64, 32, 640, 128, 208896, 5 * 64 * 64)),
    (1, 33, 64, 64, 128, ("dual", 64, 32, 640, 128, 208896, 64 * 64)),
    (1, 32, 64, 64, 128, ("recurrence", 16, 16, 128, 256, 43200, 0)),
    (1, 16, 64, 64, 128, ("recurrence", 16, 16, 128, 256, 43200, 0)),
    (8, 1, 64, 64, 128, ("recurrence", 16, 16, 128, 2048, 43200, 0)),
    # a ragged head dim (a partial tile of state rows), small N
    (2, 100, 4, 48, 16, ("dual", 64, 32, 640, 16, 79872, 2 * 2 * 64 * 64)),
    (2, 5, 4, 48, 16, ("recurrence", 16, 32, 128, 16, 16576, 0))])
def test_ssd_plan_picks_the_kernel_by_T(Bz, T, H, hd, N, want):
    """The launch ``ssd_chunked`` makes, as Python ints: the dual form above
    SSD_REC_MAX_T = 32 steps, the recurrence at or below; the grid covers every
    (sequence, head, tile of state rows); the shared bytes are what the
    kernel's ``Smem<N>`` holds (the kernel refuses any other count); the
    dual form's G = C B^T is made once per sequence and 64-step chunk."""
    plan = ssd_plan(Bz, T, H, hd, N)
    assert SSD_REC_MAX_T == 32
    assert tuple(plan) == want
    assert plan.grid == Bz * H * -(-hd // plan.rows)
    # one dual block an SM at N = 128 (128 blocks on 132 SMs), within the
    # 227 KB a block may have
    assert 232448 // 2 < ssd_plan(1, 256, 64, 64, 128).smem <= 232448
    assert all(ssd_plan(1, T, 1, 64, n, path=p).smem <= 232448
               for n in (16, 32, 64, 128) for p in ("dual", "recurrence"))
    with pytest.raises(ValueError):
        ssd_plan(1, T, 1, 64, 128, path="chunked")


def _tf32(t, rounded=True):
    """float32 to TF32 (10 mantissa bits): rounded to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` converts, or cut, as the tensor
    cores read the top 19 bits of an operand."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000 if rounded else b) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b, splits):
    """``a @ b`` as the tensor cores take it, float32 accumulation: one
    product of operands converted to TF32, or the kernel's 3xTF32 (hi = v
    cut to TF32, lo = v - hi, read cut; lo*hi' + hi*lo' + hi*hi')."""
    if splits == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a, False), _tf32(b, False)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return (al @ bh + ah @ bl) + ah @ bh


def _dual_tf32(x, B, C, dt, A, D, s0, splits, Q=64):
    """The CUDA dual-form kernel's arithmetic on the CPU: chunks of Q
    steps, its four products through ``_tf32_mm``, the decay and the
    cumsum in float32."""
    Bz, T, H, hd = x.shape
    y = torch.empty(Bz, T, H, hd)
    s = s0.clone()                                       # [Bz, H, hd, N]
    for b in range(Bz):
        for t0 in range(0, T, Q):
            n = min(Q, T - t0)
            Bc, Cc = B[b, t0:t0 + n], C[b, t0:t0 + n]      # [n, N]
            xc = x[b, t0:t0 + n].transpose(0, 1)          # [H, n, hd]
            d = dt[b, t0:t0 + n].T                         # [H, n]
            cs = torch.cumsum(d * A[:, None], 1)           # [H, n]
            mask = torch.ones(n, n, dtype=torch.bool).tril()
            L = torch.exp((cs[:, :, None] - cs[:, None, :])
                          .masked_fill(~mask, -1e30)) * d[:, None, :]
            G = _tf32_mm(Cc, Bc.T, splits)                 # [n, n]
            yc = (torch.exp(cs)[..., None]
                  * _tf32_mm(Cc, s[b].transpose(1, 2), splits)
                  + _tf32_mm(G * L, xc, splits) + D[:, None, None] * xc)
            y[b, t0:t0 + n] = yc.transpose(0, 1)
            w = torch.exp(cs[:, -1:] - cs) * d             # [H, n]
            s[b] = (torch.exp(cs[:, -1])[:, None, None] * s[b]
                    + _tf32_mm((xc * w[..., None]).transpose(1, 2), Bc,
                               splits))
    return y, s


def test_3xtf32_dual_form_holds_1e4_where_tf32_misses():
    """The numerical premise of the tensor-core SSD kernel, at mamba2's
    widths: the dual form with every product in 3xTF32 stays within the
    kernel's 1e-4 of the recurrence (the port's and the JAX package's),
    the same form with one TF32 product misses it."""
    arrs = _ssd_inputs(1, 256, 64, 64, 128, True, seed=11)
    targs = _t(arrs)
    want = tref.ssd_ref(*targs)
    jwant = jref.ssd_ref(*_j(arrs[:6]), init_state=jnp.asarray(arrs[6]))
    got3 = _dual_tf32(*targs, splits=3)
    got1 = _dual_tf32(*targs, splits=1)
    for g3, g1, w, jw in zip(got3, got1, want, jwant):
        _close(g3, w, KTOL)
        _close(g3, jw, KTOL)
        with pytest.raises(AssertionError):
            _close(g1, w, KTOL)


def test_ssd_chunked_writes_out_state_in_place_on_the_cpu():
    """``out_state`` may be ``init_state`` itself (decode's in-place update):
    the plain path reads it whole before the state is written back."""
    x, B, C, dt, A, D, s0 = _t(_ssd_inputs(2, 1, 2, 32, 16, True, seed=3))
    y, s = ssd_chunked(x, B, C, dt, A, D, s0)
    cache = s0.clone()
    y2, s2 = ssd_chunked(x, B, C, dt, A, D, cache, out_state=cache)
    assert s2 is cache
    assert torch.equal(y2, y) and torch.equal(s2, s)
    out = torch.empty_like(s0)
    y3, s3 = tops.ssd(x, B, C, dt, A, D, s0, out_state=out)
    assert s3 is out and torch.equal(s3, tref.ssd_ref(x, B, C, dt, A, D,
                                                       s0)[1])


# -------------------------------------------------------------------- model
def _models(seed=0):
    jm = dataclasses.replace(jbuild(JSMOKES[ARCH]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(seed)))
    # JAX inits A_log/dt_bias/D to 0/0/1, which would hide a swapped or
    # mis-signed A: give them values
    rng = np.random.default_rng(11)
    mix = params["seg0"][0]["mix"]
    for name, (lo, hi) in {"A_log": (-1.0, 1.0), "dt_bias": (-2.0, 0.5),
                           "D": (-1.0, 1.0)}.items():
        mix[name] = jnp.asarray(rng.uniform(lo, hi, size=mix[name].shape),
                                jnp.float32)
    tm = build_model(SMOKES[ARCH], device="cpu", dtype=torch.float32)
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


def test_full_prefill_matches_jax(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill({"tokens": toks})
    assert tl.shape == jl.shape == (1, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)


def test_suffix_prefill_matches_jax_and_leaves_the_prefix_cache(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 2)
    P = 16
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


def test_decode_steps_match_jax_in_place(pair):
    jm, params, tm = pair
    toks = _tokens(tm.cfg, 20, 3)
    n = 16
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :n],
                                                      jnp.int32)})
    _, tc = tm.prefill({"tokens": toks[:, :n]})
    state = tc[0][0]["mix"]["state"]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, out = tm.decode_step(tc, tok, n + step)
        assert out[0][0]["mix"]["state"] is state    # written in place
        _close(tl, jl)
    _caches_close(tc, jc)


def test_init_and_cache_shapes_match_jax():
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
    assert got == want      # incl. A_log, D, dt_bias, norm float32 in bf16
    mix = tm.seg0[0][0].mix
    assert torch.all(mix.D == 1) and torch.all(mix.A_log == 0)
    jc, tc = jm.init_cache(3, 10), tm.init_cache(3, 10)
    assert [[{k: (tuple(t.shape), str(t.dtype)[6:])
              for k, t in l["mix"].items()} for l in s] for s in tc] == \
        [[{k: (t.shape, str(t.dtype)) for k, t in l["mix"].items()}
          for l in s] for s in jc]


def test_full_width_plan_and_ssd_shapes():
    cfg = ARCHS[ARCH]
    tm = build_model(cfg, device="meta")
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(48, (("ssm", False, 0),))]
    mix = tm.seg0[0][0].mix
    assert tuple(mix.w_in.w.shape) == (2048, 2 * 4096 + 2 * 128 + 64)
    assert tuple(mix.conv.shape) == (4, 4096 + 2 * 128)
    assert not hasattr(tm.seg0[0][0], "ffn") or tm.seg0[0][0].ffn is None
    n = sum(p.numel() for p in tm.parameters())
    assert 1.3e9 < n < 1.4e9


def test_hybrid_still_raises():
    """Every family is served now, MLA too: ``use_mla`` on the SSM changes
    nothing (it has no attention layer to replace, in either package), and
    an int8 cache for its conv windows is still refused."""
    cfg = dataclasses.replace(SMOKES[ARCH], use_mla=True)
    tm = build_model(cfg, device="cpu")
    jm = jbuild(dataclasses.replace(JSMOKES[ARCH], use_mla=True))
    assert [(s.count, s.kinds) for s in tm.segments] == \
        [(s.count, s.kinds) for s in jm.segments] == [(2, (("ssm", False, 0),))]
    with pytest.raises(ValueError, match="int8"):
        tm.init_cache(1, 8, kv_dtype=torch.int8)


# ------------------------------------------------------------------ serving
def test_snapshot_regime_on_a_real_cache(pair):
    jm, params, tm = pair
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(20,))
    _, cache = tm.prefill({"tokens": toks[None]})
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[None], jnp.int32)})
    assert cache_has_state(cache)
    store = PagedStore(page_size=8, n_pages=8)
    index = PrefixIndex(store)
    index.insert_snapshot(toks, cache, owner_unit=1)
    q = np.concatenate([toks, rng.integers(0, cfg.vocab, size=(5,))])
    e = index.match(q)
    assert e is not None and e.n_tokens == 20 and e.owner_unit == 1
    got = index.fetch(e)
    for (_, a), (_, b) in zip(tree_leaves_with_path(cache),
                              tree_leaves_with_path(got)):
        assert torch.equal(a, b)
    assert e.bytes == cache_bytes(cache) == jcache_bytes(jc)
    with pytest.raises(ValueError):
        store.put(cache, 20)


def test_snapshot_bytes_equal_jax_in_bf16():
    """The bytes that size the Stage-1 flow: conv in the model dtype, state
    in float32, in both packages."""
    jm = jbuild(JSMOKES[ARCH])
    tm = build_model(SMOKES[ARCH], device="cpu")
    assert cache_bytes(tm.init_cache(1, 7)) == jcache_bytes(
        jm.init_cache(1, 7))


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


def _agent_stream(cfg, req_cls, seed=6):
    """A warm wave of whole prompts, then follow-ups that extend them (the
    agent shape of ``examples/serve_disagg.py``) and fresh prompts."""
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


def test_snapshot_resume_is_exact(pair):
    """A request resumed from a snapshot gives the first token and the
    continuation of the same request served cold."""
    _, _, tm = pair
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, tm.cfg.vocab, size=(24,))
    toks = np.concatenate([prefix, rng.integers(0, tm.cfg.vocab, size=(8,))])
    cold = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=1)).serve(
        [ServeRequest(0, 0.0, toks, max_new=4)])[0]
    warm = DisaggServer(tm, cfg=DisaggConfig(n_prefill_units=1)).serve(
        [ServeRequest(0, 0.0, prefix, max_new=1),
         ServeRequest(1, 1.0, toks, max_new=4)])[1]
    assert warm.reused_tokens == 24 and cold.reused_tokens == 0
    assert warm.tokens == cold.tokens


def test_launcher_runs_mamba2_on_cpu_when_asked():
    summary = run(ARCH, device="cpu", n_requests=6, policies=("mfs",),
                  verbose=False)
    s = summary["mfs"]
    assert 0.0 <= s["slo_attainment"] <= 1.0 and s["mean_ttft_ms"] > 0.0


def test_agent_stream_has_the_example_shape():
    cfg = SMOKES[ARCH]
    reqs = agent_requests(cfg, 13, seed=0, prompt=256, extend=32, fresh=288,
                          max_new=8)
    assert len(reqs) == 16 and all(r.max_new == 8 for r in reqs)
    assert [r.arrival for r in reqs[:3]] == [0.0, 0.05, 0.1]
    assert [round(r.arrival, 6) for r in reqs[3:]] == \
        [round(0.15 + i * 1e-3, 6) for i in range(13)]
    warm = [r.tokens for r in reqs[:3]]
    assert all(len(w) == 256 for w in warm)
    ext = [r for r in reqs[3:]
           if any(np.array_equal(r.tokens[:256], w) for w in warm)]
    assert all(len(r.tokens) == 288 for r in reqs[3:]) and 4 <= len(ext) <= 13


def test_example_serves_mamba2_on_cpu_with_snapshot_reuse():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/serve_disagg_torch.py"),
         "--arch", ARCH, "--device", "cpu", "--requests", "6"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    rows = [l for l in out.stdout.splitlines() if "reused" in l]
    assert len(rows) == 4
    assert all(int(l.split("reused")[1].split()[0]) >= 96 for l in rows)
