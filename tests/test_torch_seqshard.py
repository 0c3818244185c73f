"""The port's sequence-sharded decode (``ShardCtx(kv_seq_shard=True)``, the
JAX package's decode layout: every decode cache split by slots over
"model") held to the JAX package's unsharded ``decode_step`` on the CPU,
each rank a process over gloo (``launch.mesh.spawn``), at the meshes
(1, 2) and (2, 2): smoke smollm-360m widened to its real 15 heads (padded
to 16) over 5 KV heads, smoke qwen1.5-32b (4 MHA heads padded to 16) with
a bf16 model and cache and with a float32 model over an int8 cache, smoke
deepseek-moe-16b (MHA, classic EP) and smoke deepseek-v3 (MLA under TP,
its latent cache split by slots).

Four sequences of lengths 5, 9, 7 and 15 are prefilled one by one, each
handed to a decode cache of 16 slots (``launch.shardings.decode_cache``:
every real KV head, grown to the 16 slots and cut into the rank's 8) and
the rows joined; 3 greedy steps then run each sequence at its own
position: the first sequence's keys stay in rank 0's slots (rank 1 holds
none of them: an empty partial), the second's new tokens go to rank 1,
the third crosses the boundary, the fourth runs past the capacity (its
writes clamp to the last slot). JAX runs each sequence alone from its
own prefill with a scalar position. Compared: each call's logits within
``TOL`` (float32), ``INT8_TOL`` (over int8 codes) or ``BF16_TOL`` (bf16)
of the largest logit, the greedy
tokens equal, and the logical cache gathered over the slots
(``gather_cache``) within the same tolerance (int8 codes within one
code).

Also on one process: the plain partial of the decode kernel
(``decode_attention_plain(partial=True)``) over m slices of the slots,
merged by ``merge_partials``, against the plain version over the whole
and JAX's decode oracle, empty slices included; the flag at a model axis
of one rank bitwise the layout without it; and slots the ranks do not
divide refused."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.kernels import ref as jref
from repro.models.blocks import _kv_store as jkv_store
from repro.models.lm import build_model as jbuild
from repro_torch.configs import SMOKES
from repro_torch.kernels.attn_split import attn_merge, merge_partials
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.launch.mesh import spawn
from repro_torch.launch.shardings import decode_cache
from repro_torch.models import build_model
from repro_torch.models.sharding import ShardCtx, slot_block

import _sharded_ranks as ranks

TOL = 1e-5          # float32, of the largest value, as the sharded tests
BF16_TOL = 2e-2     # a bf16 model on both sides: rounding order differs
#: float32 over an int8 cache: a new key a rounding apart may take the
#: next code (1/32 off), as tests/test_torch_int8.py's 2e-4
INT8_TOL = 2e-4
S, STEPS = 16, 3
LENGTHS = (5, 9, 7, 15)
SMOLLM15 = {"n_heads": 15, "n_kv": 5, "d_model": 120}
#: name -> (arch, config changes, model dtype, KV dtype)
JOBS = {
    "smollm-15over5": ("smollm-360m", SMOLLM15, "float32", "same"),
    "qwen-bf16": ("qwen1.5-32b", {}, "bfloat16", "same"),
    "qwen-int8": ("qwen1.5-32b", {}, "float32", "int8"),
    "deepseek-moe": ("deepseek-moe-16b", {}, "float32", "same"),
    "deepseek-v3-mla": ("deepseek-v3-671b", {}, "float32", "same"),
}
MESHES = ((1, 2), (2, 2))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _pad_slots(a):
    return jnp.pad(a, [(0, 0), (0, 0), (0, S - a.shape[2])]
                   + [(0, 0)] * (a.ndim - 3))


def _reference(name):
    """JAX's unsharded model, each sequence alone: its prefill, its cache
    given the real KV heads (a decode cache's) and grown to ``S`` slots
    (int8 codes where asked), ``STEPS`` greedy steps at its own scalar
    position. Returns the JAX weights, the prompts, each call's logits
    [B, 1, V] (rows joined), the greedy tokens [B, STEPS + 1] and the
    final caches (rows joined)."""
    arch, changes, dtype, kv = JOBS[name]
    cfg = dataclasses.replace(JSMOKES[arch], **changes)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = dataclasses.replace(jbuild(cfg), dtype=jdt)
    params = jax.tree.map(lambda a: a.astype(jdt) if a.dtype != jnp.float32
                          or jdt == jnp.float32 else a,
                          jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int64)
               for n in LENGTHS]
    step = jax.jit(jm.decode_step)
    logits, greedy, caches = [], [], []
    for toks in prompts:
        lg, c = jm.prefill(params, {"tokens": jnp.asarray(toks[None],
                                                          jnp.int32)})

        def leaf(path, a):
            n = getattr(path[-1], "key", None)
            if n in ("k", "v"):
                a = a[:, :, :, :cfg.n_kv]
                if kv == "int8":
                    a = jkv_store(a, jnp.int8)
            return _pad_slots(a)
        c = jax.tree_util.tree_map_with_path(leaf, c)
        lgs = [lg]
        tok = jnp.argmax(lg[:, 0], -1)[:, None]
        toks_out = [tok]
        for s in range(STEPS):
            lg, c = step(params, c, tok, len(toks) + s)
            lgs.append(lg)
            tok = jnp.argmax(lg[:, 0], -1)[:, None]
            toks_out.append(tok)
        logits.append([np.asarray(x, np.float32) for x in lgs])
        greedy.append(np.asarray(jnp.concatenate(toks_out, 1)))
        caches.append(c)
    joined = jax.tree.map(lambda *xs: np.concatenate(
        [np.asarray(x, np.float32) for x in xs], 1), *caches)
    return {"params": jax.tree.map(
                lambda a: np.asarray(a, np.float32), params),
            "prompts": prompts,
            "logits": [np.concatenate([r[i] for r in logits], 0)
                       for i in range(STEPS + 1)],
            "greedy": np.concatenate(greedy, 0), "caches": joined}


_CACHE = {}


def _run(name, mesh, tmp_path_factory):
    """The JAX reference and the sequence-sharded run of every job on
    ``mesh``, computed once (every job in one spawn a mesh)."""
    for n in JOBS:
        if n not in _CACHE:
            _CACHE[n] = _reference(n)
    if mesh not in _CACHE:
        data, m = mesh
        pg = tmp_path_factory.mktemp("pg") / "store"
        jobs = [(JOBS[n][0], _CACHE[n]["params"], _CACHE[n]["prompts"], S,
                 JOBS[n][2], JOBS[n][3], JOBS[n][1]) for n in JOBS]
        _CACHE[mesh] = dict(zip(JOBS, spawn(
            ranks.seq_decode, data * m, (m, jobs, STEPS),
            init_method=f"file://{pg}")[0]))
    return _CACHE[name], _CACHE[mesh][name]


@pytest.fixture(params=[(n, m) for n in JOBS for m in MESHES],
                ids=[f"{n}-{m[0]}x{m[1]}" for n in JOBS for m in MESHES])
def run(request, tmp_path_factory):
    name, mesh = request.param
    ref, got = _run(name, mesh, tmp_path_factory)
    return name, mesh, ref, got


def _tol(name):
    if JOBS[name][3] == "int8":
        return INT8_TOL
    return BF16_TOL if JOBS[name][2] == "bfloat16" else TOL


def test_seq_sharded_decode_logits_match_jax(run):
    name, mesh, ref, got = run
    assert got["local_slots"] == S // mesh[1]
    for g, w in zip(got["logits"], ref["logits"]):
        _close(g, w, _tol(name))


def test_seq_sharded_greedy_tokens_match_jax(run):
    """Equal tokens; for the bf16 model, a pick may differ only where JAX's
    logit of it is within twice ``BF16_TOL`` (of the largest logit) of
    JAX's largest: a near tie that either package's rounding may break."""
    name, _, ref, got = run
    if JOBS[name][2] != "bfloat16":
        np.testing.assert_array_equal(got["greedy"], ref["greedy"])
        return
    for i, lg in enumerate(ref["logits"]):
        lg = lg[:, 0]
        scale = float(np.abs(lg).max())
        for b in np.nonzero(got["greedy"][:, i] != ref["greedy"][:, i])[0]:
            gap = lg[b].max() - lg[b, got["greedy"][b, i]]
            assert gap <= 2 * BF16_TOL * scale, (b, i, gap, scale)


def test_seq_sharded_cache_gathered_over_slots_matches_jax(run):
    """The logical cache after the steps, every rank's slots joined: each
    token leaf within the tolerance (an int8 cache's codes within one
    code: a new key a float32 rounding apart may round to the next)."""
    name, _, ref, got = run
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref["caches"]):
        t = got["caches"]
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        if JOBS[name][3] == "int8":
            np.testing.assert_allclose(t, leaf, atol=1, rtol=0)
        else:
            _close(t, leaf, _tol(name))


def test_seq_sharded_exchange_bytes(run):
    """A rank sends a step, a layer, its query heads to every other rank
    and its partials ([o, lse], float32) of the others' heads; an MHA
    model's rank also its block of the new token's K and V heads."""
    name, mesh, _, got = run
    arch, changes, dtype, _ = JOBS[name]
    cfg = dataclasses.replace(SMOKES[arch], **changes)
    data, m = mesh
    B = len(LENGTHS) // data
    es = 4 if dtype == "float32" else 2
    if cfg.use_mla:
        h = cfg.n_heads // m
        per = (B * h * (cfg.kv_lora_rank + cfg.rope_head_dim) * 4 * (m - 1)
               + B * (cfg.n_heads - h) * (cfg.kv_lora_rank + 1) * 4)
    else:
        nq = 16                                 # padded query heads
        h = nq // m
        per = (B * h * cfg.hd * es * (m - 1)
               + B * (nq - h) * (cfg.hd + 1) * 4)
        if cfg.n_kv == cfg.n_heads:             # MHA: K and V blocks
            per += 2 * B * h * cfg.hd * es * (m - 1)
    assert got["seq_bytes"] == per * cfg.n_layers


# -------------------------------------------------- one process, no spawn
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kv", ["gqa16to5", "mha", "int8"])
def test_partials_merged_match_whole_and_jax_oracle(m, kv):
    """The plain partial mode over m slices of 40 slots, merged by
    ``merge_partials`` (and ``attn_merge``, which is it on the CPU), is the
    plain version over the whole and JAX's decode oracle, to 1e-6; a
    length of 0 gives 0, and a slice past a row's length gives lse -inf
    and an output of 0."""
    rng = np.random.default_rng(m + len(kv))
    B, H, D, Sw = 6, 16, 32, 40
    Hk = 5 if kv == "gqa16to5" else H
    kv_map = (torch.tensor([min(h // 3, 4) for h in range(H)],
                           dtype=torch.int32) if kv == "gqa16to5" else None)
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, Sw, Hk, D))
                             .astype(np.float32)) for _ in range(2))
    kw = {}
    if kv == "int8":
        k, v = (torch.clamp(torch.round(x * 32), -127, 127).to(torch.int8)
                for x in (k, v))
        kw["kv_scale"] = 1 / 32
    lengths = torch.tensor([0, 1, 9, 40, 21, 30])
    n = Sw // m
    parts = [decode_attention_plain(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
        (lengths - r * n).clamp(0, n), kv_map=kv_map, partial=True, **kw)
        for r in range(m)]
    o = torch.stack([p[0].reshape(B * H, D) for p in parts])
    lse = torch.stack([p[1].reshape(B * H) for p in parts])
    for r, (po, pl) in enumerate(parts):
        empty = (lengths - r * n) <= 0
        assert torch.all(torch.isinf(pl[empty])) and torch.all(pl[empty] < 0)
        assert torch.all(po[empty] == 0)
        assert po.dtype == torch.float32 and pl.shape == (B, H)
    merged = merge_partials(o, lse).reshape(B, H, D)
    whole = decode_attention_plain(q, k, v, lengths, kv_map=kv_map, **kw)
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(attn_merge(o, lse).reshape(B, H, D), merged,
                               atol=0, rtol=0)
    assert torch.all(merged[0] == 0)
    kx, vx = ((x.float() / 32 if kv == "int8" else x) for x in (k, v))
    if kv_map is not None:
        kx, vx = (x[:, :, kv_map.long()] for x in (kx, vx))
    want = jref.decode_attention_ref(jnp.asarray(q.numpy()),
                                     jnp.asarray(kx.numpy()),
                                     jnp.asarray(vx.numpy()),
                                     jnp.asarray(lengths.numpy(), jnp.int32))
    np.testing.assert_allclose(merged[1:].numpy(), np.asarray(want)[1:],
                               atol=1e-6, rtol=1e-6)


def test_partial_lse_is_the_log_sum_exp_in_base_2():
    """The partial's lse over a row's keys is log2 of the sum of
    ``2 ** (q . k * scale * log2 e)``: the natural log-sum-exp over ln 2."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 5, 2, 8))
                             .astype(np.float32)) for _ in range(2))
    _, lse = decode_attention_plain(q, k, v, torch.tensor([4]), partial=True)
    s = torch.einsum("bhd,bshd->bhs", q, k[:, :4]) / math.sqrt(8)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1) / math.log(2))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen1.5-32b",
                                  "deepseek-v3-671b"])
def test_flag_at_one_model_rank_is_bitwise_the_layout_without_it(arch):
    """At a model axis of one rank ``kv_seq_shard`` changes nothing: the
    same cache shapes, and a prefill and 3 decode steps bitwise those of the
    same mesh without the flag."""
    out = []
    for flag in (False, True):
        ctx = ShardCtx(mesh=ranks.fake_mesh(1, 1), kv_seq_shard=flag)
        assert slot_block(ctx, 10) == (0, 10)
        model = build_model(SMOKES[arch], device="cpu", dtype=torch.float32,
                            ctx=ctx,
                            generator=torch.Generator().manual_seed(0))
        toks = torch.arange(6)[None] % model.cfg.vocab
        lg, caches = model.prefill({"tokens": toks})
        cache = model.init_cache(1, 12)
        for si, seg in enumerate(cache):
            for i, entry in enumerate(seg):
                for n, t in entry["mix"].items():
                    src = caches[si][i]["mix"][n]
                    t[:, :, :6] = src[:, :, :, :t.shape[3]] \
                        if t.dim() == 5 else src
        lgs = [lg]
        tok = lg[:, 0].argmax(-1, keepdim=True)
        for s in range(3):
            lg, cache = model.decode_step(cache, tok, 6 + s)
            lgs.append(lg)
            tok = lg[:, 0].argmax(-1, keepdim=True)
        out.append((lgs, cache))
    (a, ca), (b, cb) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for sa, sb in zip(ca, cb):
        for ea, eb in zip(sa, sb):
            for n in ea["mix"]:
                assert torch.equal(ea["mix"][n], eb["mix"][n])


def test_slots_the_ranks_do_not_divide_raise():
    """A sequence-sharded cache needs the model axis to divide its slots:
    ``init_cache``, ``decode_cache`` and ``slot_block`` refuse 15 over 2."""
    ctx = ShardCtx(mesh=ranks.fake_mesh(1, 2), kv_seq_shard=True)
    assert slot_block(ctx, 16) == (0, 8)
    with pytest.raises(ValueError, match="must divide"):
        slot_block(ctx, 15)
    model = build_model(SMOKES["qwen1.5-32b"], device="cpu",
                        dtype=torch.float32, ctx=ctx)
    with pytest.raises(ValueError, match="must divide"):
        model.init_cache(2, 15)
    cache = model.init_cache(2, 16)
    assert cache[0][0]["mix"]["k"].shape == (2, 2, 8, 4, model.cfg.hd)
    gqa = build_model(SMOKES["smollm-360m"], device="cpu",
                      dtype=torch.float32, ctx=ctx)   # no heads to gather
    with pytest.raises(ValueError, match="must divide"):
        decode_cache([[{"mix": {"k": torch.zeros(1, 1, 15, 1, 8)}}]], gqa,
                     15, 15)
