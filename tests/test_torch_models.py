"""The port's dense decoder held against the JAX model: the same weights
(the JAX ``Model.init`` pytree in float32, loaded through
``from_jax_params``) and the same tokens give the same logits and caches for
full prefill, suffix prefill at pos=16 and four decode steps. Run on
smollm-smoke (MQA) and on a non-uniform q->kv map that pads 15 heads to 16
like full smollm."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SMOKES as JSMOKES
from repro.models import layers as jlayers
from repro.models.lm import build_model as jbuild
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, from_jax_params
from repro_torch.models import layers as tlayers
from repro_torch.models.blocks import AttnDims

TOL = 2e-4          # float32 through 2-layer models, summation order differs

VARIANTS = {
    "smoke": {},                                             # 3 heads, MQA
    "nonuniform": {"n_heads": 15, "n_kv": 5, "d_model": 120},  # 15 -> 16
    "qkv_bias": {"qkv_bias": True},
}


def _models(variant):
    jcfg = dataclasses.replace(JSMOKES["smollm-360m"], **VARIANTS[variant])
    tcfg = dataclasses.replace(SMOKES["smollm-360m"], **VARIANTS[variant])
    jm = dataclasses.replace(jbuild(jcfg), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    if tcfg.qkv_bias:       # JAX inits biases to 0: give them values
        rng = np.random.default_rng(11)
        for name in ("wq", "wk", "wv"):
            b = params["seg0"][0]["mix"][name]["b"]
            params["seg0"][0]["mix"][name]["b"] = jnp.asarray(
                rng.normal(size=b.shape) * 0.1, jnp.float32)
    tm = build_model(tcfg, device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return (request.param,) + _models(request.param)


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _caches_close(tc, jc):
    jl = jax.tree_util.tree_leaves_with_path(jc)
    for path, leaf in jl:
        t = tc
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(t.shape) == leaf.shape, path
        _close(t, leaf)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(1, n))


def test_full_prefill_matches_jax(pair):
    _, jm, params, tm = pair
    toks = _tokens(tm.cfg, 24, 1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill({"tokens": toks})
    assert tl.shape == jl.shape == (1, 1, tm.vocab_padded)
    _close(tl, jl)
    _caches_close(tc, jc)


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
    jc = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 8), (0, 0),
                                            (0, 0)]), jc)
    tc = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 8))
                    for k, t in layer["mix"].items()}} for layer in seg]
          for seg in tc]
    for step in range(4):
        tok = toks[:, n + step:n + step + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok, jnp.int32),
                                n + step)
        tl, tc = tm.decode_step(tc, tok, n + step)
        _close(tl, jl)
    _caches_close(tc, jc)


def test_per_slot_positions_match_separate_sequences(pair):
    """One batched decode step at two different positions == each sequence
    decoded alone."""
    _, _, _, tm = pair
    toks = _tokens(tm.cfg, 12, 4)
    caches, logits_alone = [], []
    for n in (7, 11):
        _, c = tm.prefill({"tokens": toks[:, :n]})
        caches.append([[{"mix": {k: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, 12 - n)) for k, t in layer["mix"].items()}}
            for layer in seg] for seg in c])
    a, b = caches
    batched = [[{"mix": {k: torch.cat([a[si][li]["mix"][k],
                                       b[si][li]["mix"][k]], 1)
                         for k in ("k", "v")}}
                for li in range(len(a[si]))] for si in range(len(a))]
    for n, c in zip((7, 11), caches):
        lg, _ = tm.decode_step(
            [[{"mix": {k: t.clone() for k, t in layer["mix"].items()}}
              for layer in seg] for seg in c], toks[:, n:n + 1], n)
        logits_alone.append(lg)
    tok = np.concatenate([toks[:, 7:8], toks[:, 11:12]])
    lg, _ = tm.decode_step(batched, tok, torch.tensor([7, 11]))
    _close(lg[0], logits_alone[0][0])
    _close(lg[1], logits_alone[1][0])


def test_init_matches_jax_shapes_and_zeroed_rows(pair):
    name, jm, params, _ = pair
    cfg = dataclasses.replace(SMOKES["smollm-360m"], **VARIANTS[name])
    tm = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        if keys[0].startswith("seg"):
            for c in range(leaf.shape[0]):
                want[".".join([keys[0], str(c)] + keys[1:])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    dims = AttnDims.of(cfg)
    wo = tm.seg0[0][0].mix.wo.w
    assert torch.all(wo[cfg.n_heads * dims.hd:] == 0)
    assert wo.dtype == torch.bfloat16 and tm.ln_f.g.dtype == torch.float32
    d = cfg.d_model
    assert abs(float(tm.embed.float().std()) - d ** -0.5) < 0.2 * d ** -0.5


def test_init_cache_matches_jax():
    cfg = SMOKES["smollm-360m"]
    jm = jbuild(JSMOKES["smollm-360m"])
    tm = build_model(cfg, device="cpu")
    jc = jm.init_cache(3, 10)
    tc = tm.init_cache(3, 10)
    assert [[{k: tuple(t.shape) for k, t in l["mix"].items()} for l in s]
            for s in tc] == [[{k: t.shape for k, t in l["mix"].items()}
                              for l in s] for s in jc]


def test_q_to_kv_map_nonuniform_at_full_width():
    cfg = ARCHS["smollm-360m"]
    dims = AttnDims.of(cfg)
    assert (dims.n_q, dims.n_kv, dims.hd) == (16, 5, 64)
    assert dims.q_to_kv(cfg).tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                                          4, 4, 4, 4]


def test_unsupported_family_raises():
    """Every family of the JAX package builds now: experts, MLA,
    encoder-decoder, MTP, the VLM backbone, every smoke config. What the
    port still refuses is an int8 cache whose leaves the JAX model would
    read as codes (MLA's latents, an encoder-decoder's cross K/V)."""
    base = SMOKES["smollm-360m"]
    mla = dict(use_mla=True, kv_lora_rank=16, q_lora_rank=32,
               rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    for change in (mla, dict(enc_layers=2), dict(mtp=True),
                   dict(family="audio"), dict(n_experts=4, top_k=2)):
        build_model(dataclasses.replace(base, **change), device="cpu")
    for cfg in SMOKES.values():
        build_model(cfg, device="cpu")
    for change, src_len in ((mla, 0), (dict(enc_layers=2), 4)):
        m = build_model(dataclasses.replace(base, **change), device="cpu")
        with pytest.raises(ValueError, match="int8"):
            m.init_cache(1, 8, kv_dtype=torch.int8, src_len=src_len)


# ------------------------------------------------------------------ layers
def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    g = rng.normal(size=(32,)).astype(np.float32)
    _close(tlayers.rmsnorm(torch.from_numpy(g), torch.from_numpy(x)),
           jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)), 1e-5)
    pos = np.arange(3, 8)[None]
    ts, tc = tlayers.rope(torch.from_numpy(pos), 32)
    js, jc = jlayers.rope(jnp.asarray(pos), 32)
    _close(ts, js, 1e-5)
    _close(tc, jc, 1e-5)
    _close(tlayers.apply_rope(torch.from_numpy(x), ts, tc),
           jlayers.apply_rope(jnp.asarray(x), js, jc), 1e-5)


def test_gqa_attention_matches_jax_and_decode_kernel_semantics():
    """The JAX decode path's ``gqa_attention`` with mask k_pos <= pos is the
    port's decode attention with lengths = pos + 1."""
    rng = np.random.default_rng(13)
    B, S, Hkv, rep, D = 2, 12, 2, 3, 32
    q = rng.normal(size=(B, 1, Hkv * rep, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    pos = 7
    mask = (np.arange(S) <= pos)[None, None, :].repeat(B, 0)
    want = jlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), mask=jnp.asarray(mask))
    got = tlayers.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                mask=torch.from_numpy(mask))
    _close(got, want, 1e-5)
    qmap = torch.arange(Hkv * rep) // rep
    kx, vx = (torch.from_numpy(a).index_select(2, qmap) for a in (k, v))
    dec = tref.decode_attention_ref(torch.from_numpy(q[:, 0]), kx, vx,
                                    torch.full((B,), pos + 1))
    _close(dec, got[:, 0], 1e-5)
