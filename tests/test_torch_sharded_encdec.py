"""Tensor parallelism of the encoder-decoder (smoke seamless-m4t-medium: 2
encoder and 2 decoder layers, 4 MHA heads padded to 16, 8 a rank at a
model axis of 2, a cross-attention sublayer in each decoder layer) held
to the JAX package's unsharded model on the CPU at the meshes (1, 2) and
(2, 2), each rank a process over gloo (``launch.mesh.spawn``). The
encoder's attention and SwiGLU and the decoder's self- and
cross-attention run the rank's heads (``blocks.cross_apply``: x and the
encoder's memory enter through ``copy_to``, ``wo``'s partial products
summed), the memory whole on every rank. The same converted float32
weights on both sides; 12 source frames a sequence; the prefill's last
logits and logical caches (the self- and cross-attention K/V of the
ranks' heads joined), 3 greedy tokens, the loss and every logical
gradient, within 1e-5 of each tensor's largest value, as
``tests/test_torch_sharded_mla.py``.

At (1, 2) with ``kv_seq_shard`` the cross K/V are split by source
position, 6 of the 12 frames a rank with every real KV head
(``launch.shardings.decode_cache``), beside the self-attention caches
split by slots: prompts of 5, 9, 7 and 15 tokens over their own source
frames, each prefilled alone and handed to a decode cache of 16 slots,
then 3 greedy steps at each row's own position, held to JAX's model on
each prompt alone: each call's logits, the greedy tokens and the logical
cache after the steps (``gather_cache``; JAX's cross K/V keep the padded
heads, of which the real ones are compared)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models.lm import build_model as jbuild
from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import spawn
from repro_torch.launch.shardings import (decode_cache, grad_sum_axes,
                                          model_splits)
from repro_torch.models import build_model
from repro_torch.models.convert import to_jax_tree
from repro_torch.models.sharding import ShardCtx

import _sharded_ranks as ranks

TOL = 1e-5
ARCH = "seamless-m4t-medium"
MESHES = ((1, 2), (2, 2))
B, T, SRC, STEPS = 4, 15, 12, 3
SEQ_LENGTHS, SEQ_S = (5, 9, 7, 15), 16


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _jax_model():
    jm = dataclasses.replace(jbuild(JSMOKES[ARCH]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    return jm, params


def _src(rng, *shape):
    return rng.normal(size=shape + (JSMOKES[ARCH].d_model,)).astype(
        np.float32)


def _grown(caches, S, real=None):
    """JAX's prefill caches as a decode cache of ``S`` slots: the
    self-attention K/V grown (their real heads only, with ``real``), the
    cross K/V as they are (their real heads only, with ``real``)."""
    def leaf(path, a):
        name = getattr(path[-1], "key", None)
        if real is not None and name in ("k", "v", "xk", "xv"):
            a = a[:, :, :, :real]
        if name in ("k", "v"):
            a = jnp.pad(a, [(0, 0), (0, 0), (0, S - a.shape[2]), (0, 0),
                            (0, 0)])
        return a
    return jax.tree_util.tree_map_with_path(leaf, caches)


def _reference():
    """JAX's unsharded model: float32 weights, the prefill's logits and
    caches, greedy tokens over the caches grown by ``STEPS`` slots, the
    loss and its gradients."""
    jm, params = _jax_model()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, JSMOKES[ARCH].vocab, (B, T)).astype(np.int64)
    src = _src(rng, B, SRC)
    jt = jnp.asarray(toks, jnp.int32)
    logits, caches = jm.prefill(params, {"tokens": jt,
                                         "src_embeds": jnp.asarray(src)})
    grown = _grown(caches, T + STEPS)
    tok = jnp.argmax(logits[:, 0], -1)[:, None]
    greedy = [tok]
    for s in range(STEPS):
        lg, grown = jm.decode_step(params, grown, tok, T + s)
        tok = jnp.argmax(lg[:, 0], -1)[:, None]
        greedy.append(tok)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {"tokens": jt, "labels": jt, "src_embeds": jnp.asarray(src)})
    return {"params": jax.tree.map(np.asarray, params), "tokens": toks,
            "src": src, "logits": np.asarray(logits), "caches": caches,
            "greedy": np.asarray(jnp.concatenate(greedy, 1)),
            "loss": float(loss), "grads": grads}


def _seq_reference(params):
    """Each of ``SEQ_LENGTHS``' prompts alone over its own ``SRC`` source
    frames through JAX's model: its prefill grown to ``SEQ_S`` slots and
    ``STEPS`` greedy steps at its own scalar position. Returns the prompts
    and frames, each call's logits and the greedy tokens (rows joined) and
    the final caches (rows joined; the real KV heads)."""
    jm, _ = _jax_model()
    params = jax.tree.map(jnp.asarray, params)
    n_kv = JSMOKES[ARCH].n_kv
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, JSMOKES[ARCH].vocab, n).astype(np.int64)
               for n in SEQ_LENGTHS]
    srcs = [_src(rng, SRC) for _ in SEQ_LENGTHS]
    step = jax.jit(jm.decode_step)
    logits, greedy, caches = [], [], []
    for toks, src in zip(prompts, srcs):
        lg, c = jm.prefill(params, {
            "tokens": jnp.asarray(toks[None], jnp.int32),
            "src_embeds": jnp.asarray(src[None])})
        c = _grown(c, SEQ_S)
        lgs, tok = [lg], jnp.argmax(lg[:, 0], -1)[:, None]
        picks = [tok]
        for s in range(STEPS):
            lg, c = step(params, c, tok, len(toks) + s)
            lgs.append(lg)
            tok = jnp.argmax(lg[:, 0], -1)[:, None]
            picks.append(tok)
        logits.append([np.asarray(x, np.float32) for x in lgs])
        greedy.append(np.asarray(jnp.concatenate(picks, 1)))
        caches.append(_grown(c, SEQ_S, real=n_kv))
    return {"prompts": prompts, "srcs": srcs,
            "logits": [np.concatenate([r[i] for r in logits], 0)
                       for i in range(STEPS + 1)],
            "greedy": np.concatenate(greedy, 0),
            "caches": jax.tree.map(lambda *xs: np.concatenate(
                [np.asarray(x, np.float32) for x in xs], 1), *caches)}


_CACHE = {}


def _ref():
    if "ref" not in _CACHE:
        _CACHE["ref"] = _reference()
    return _CACHE["ref"]


@pytest.fixture(params=MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def run(request, tmp_path_factory):
    mesh = request.param
    ref = _ref()
    if mesh not in _CACHE:
        data, m = mesh
        pg = tmp_path_factory.mktemp("pg") / "store"
        jobs = [(ARCH, ref["params"], ref["tokens"], None, ref["src"])]
        _CACHE[mesh] = spawn(ranks.serve_and_grads, data * m,
                             (m, jobs, STEPS),
                             init_method=f"file://{pg}")[0][0]
    return mesh, ref, _CACHE[mesh]


@pytest.fixture
def seq(tmp_path_factory):
    """The JAX reference and the (1, 2) ``kv_seq_shard`` run."""
    if "seq" not in _CACHE:
        ref = _seq_reference(_ref()["params"])
        pg = tmp_path_factory.mktemp("pg") / "store"
        job = (ARCH, _ref()["params"], ref["prompts"], SEQ_S, "float32",
               "same", {}, ref["srcs"])
        got = spawn(ranks.seq_decode, 2, (2, [job], STEPS),
                    init_method=f"file://{pg}")[0][0]
        _CACHE["seq"] = (ref, got)
    return _CACHE["seq"]


def _tree_close(got, ref_tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree):
        t = got
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        _close(t, leaf)


def test_encdec_tp_prefill_logits_match_jax(run):
    _, ref, got = run
    _close(got["logits"], ref["logits"])


def test_encdec_tp_logical_caches_match_jax(run):
    """The ranks' heads of the self-attention K/V and of the cross K/V
    joined are JAX's (the padded heads included)."""
    _, ref, got = run
    _tree_close(got["caches"], ref["caches"])


def test_encdec_tp_greedy_tokens_match_jax(run):
    _, ref, got = run
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])


def test_encdec_tp_loss_and_every_gradient_match_jax(run):
    """The encoder's gradients too: each layer's cross K/V projections of
    the memory give a rank's partial gradient of it, summed over
    "model"."""
    _, ref, got = run
    assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    tree = to_jax_tree({n: torch.from_numpy(g)
                        for n, g in got["grads"].items()})
    want = jax.tree.map(np.asarray, ref["grads"])
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(_close, tree, want)


def test_cross_kv_seq_sharded_logits_match_jax(seq):
    ref, got = seq
    assert got["local_slots"] == SEQ_S // 2
    for g, w in zip(got["logits"], ref["logits"]):
        _close(g, w)


def test_cross_kv_seq_sharded_greedy_tokens_match_jax(seq):
    ref, got = seq
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])


def test_cross_kv_seq_sharded_cache_matches_jax(seq):
    """The self-attention K/V joined over their slots and the cross K/V
    over their source positions, the real heads: JAX's, row by row."""
    ref, got = seq
    _tree_close(got["caches"], ref["caches"])


# -------------------------------------------------- one process, no spawn
def test_encdec_placements_and_cache_shapes():
    """At a model axis of 2 the cross-attention holds the rank's 8 of the
    16 padded heads (query and KV: MHA), ``wo`` its rows, as the encoder's
    and the decoder's self-attention; the caches the rank's heads, or with
    ``kv_seq_shard`` every real KV head over the rank's slots and source
    positions."""
    cfg = SMOKES[ARCH]
    ctx = ShardCtx(mesh=ranks.fake_mesh(1, 2))
    model = build_model(cfg, device="cpu", dtype=torch.float32, ctx=ctx)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    cols = 8 * cfg.hd
    for a in ("seg0.0.0.xattn", "seg0.0.0.mix", "encoder.1.mix"):
        for w in ("wq", "wk", "wv"):
            assert shapes[f"{a}.{w}.w"] == (cfg.d_model, cols)
        assert shapes[f"{a}.wo.w"] == (cols, cfg.d_model)
    splits = model_splits(model)
    assert grad_sum_axes("seg0.0.0.xattn.wk.w",
                         splits["seg0.0.0.xattn.wk.w"], cfg, ctx) == ()
    entry = model.init_cache(2, 20, src_len=SRC)[0][0]
    assert tuple(entry["xk"].shape) == (cfg.n_layers, 2, SRC, 8, cfg.hd)
    assert tuple(entry["mix"]["k"].shape) == (cfg.n_layers, 2, 20, 8,
                                              cfg.hd)
    seq = build_model(cfg, device="cpu", dtype=torch.float32,
                      ctx=ShardCtx(mesh=ranks.fake_mesh(1, 2),
                                   kv_seq_shard=True))
    entry = seq.init_cache(2, 20, src_len=SRC)[0][0]
    assert tuple(entry["xv"].shape) == (cfg.n_layers, 2, SRC // 2,
                                        cfg.n_kv, cfg.hd)
    assert tuple(entry["mix"]["v"].shape) == (cfg.n_layers, 2, 10, cfg.n_kv,
                                              cfg.hd)
    with pytest.raises(ValueError, match="must divide"):
        seq.init_cache(2, 20, src_len=SRC + 1)


def test_decode_cache_hand_over_at_one_model_rank():
    """At a model axis of one rank (with the flag or without it: no
    sequence sharding) the hand-over grows each self-attention leaf to the
    capacity with zeros and keeps the cross K/V as the prefill made them,
    the padded heads with them."""
    cfg = SMOKES[ARCH]
    for flag in (False, True):
        model = build_model(cfg, device="cpu", dtype=torch.float32,
                            ctx=ShardCtx(mesh=ranks.fake_mesh(1, 1),
                                         kv_seq_shard=flag),
                            generator=torch.Generator().manual_seed(0))
        src = torch.from_numpy(_src(np.random.default_rng(0), 1, SRC))
        _, caches = model.prefill({"tokens": torch.arange(6)[None],
                                   "src_embeds": src})
        got = decode_cache(caches, model, 6, 10)[0][0]
        assert tuple(got["mix"]["k"].shape) == (cfg.n_layers, 1, 10, 16,
                                                cfg.hd)
        assert torch.equal(got["mix"]["k"][:, :, :6],
                           caches[0][0]["mix"]["k"])
        assert torch.all(got["mix"]["k"][:, :, 6:] == 0)
        assert got["xk"] is caches[0][0]["xk"]
