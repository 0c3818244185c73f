"""Tensor parallelism of RG-LRU (smoke recurrentgemma-9b: one (rec, rec,
attn) unit, width 128 in 16 gate blocks, 8 a rank at a model axis of 2;
local MQA attention with a window of 16) held to the JAX package's
unsharded model on the CPU at the meshes (1, 2) and (2, 2), each rank a
process over gloo (``launch.mesh.spawn``). ``w_x``, ``w_gate_branch``, the
gates and ``a_param`` hold the rank's channels, ``w_out_rg`` its rows; the
conv taps stay whole (JAX's placement), their partial gradients summed
over "model"; the decode caches hold the rank's channels of ``conv`` and
``state``. The same converted float32 weights on both sides; the
prefill's last logits and logical caches, 3 greedy tokens, the loss and
every logical gradient, within 1e-5 of each tensor's largest value, as
``tests/test_torch_sharded_mla.py``. The prompts are 21 tokens, past the
window: the prefill's cropped window goes into ring order
(``launch.shardings.decode_cache``) and decode wraps the ring.

At (1, 2) with ``kv_seq_shard`` the ring of 16 slots is split 8 / 8 over
the ranks: prompts of 21, 15, 5 and 26 tokens, each prefilled alone and
handed to decode (its window rolled into the ring, its slots cut), then 3
greedy steps at each row's own position: the first row's ring wrapped
before decode and its new keys go to rank 0, the second's wrap during
decode from rank 1's slots into rank 0's, the third's ring is not full,
the fourth's new keys go to rank 1. JAX runs each prompt alone from its
own prefill, its window rolled and grown to the ring's 16 slots. Compared
within the same tolerance: each call's logits, the greedy tokens and the
logical cache after the steps (``gather_cache``: the ring over its slots,
the RG-LRU leaves over their channels)."""
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
from repro_torch.launch.shardings import grad_sum_axes, model_splits
from repro_torch.models import build_model
from repro_torch.models.convert import to_jax_tree
from repro_torch.models.sharding import ShardCtx

import _sharded_ranks as ranks

TOL = 1e-5
ARCH = "recurrentgemma-9b"
MESHES = ((1, 2), (2, 2))
B, T, STEPS = 4, 21, 3
#: the sequence-sharded decode's prompts and its decode capacity (the
#: ring keeps min(S, window) = 16 slots)
SEQ_LENGTHS, SEQ_S = (21, 15, 5, 26), 32


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _handed(caches, n, S):
    """JAX's prefill caches of ``n`` positions as a decode cache of ``S``
    slots, as ``DecodeBatch.add`` admits them: a window leaf rolled into
    ring order (position p at slot p % its slots) and grown to
    ``min(S, window)`` slots; the RG-LRU leaves as they are."""
    window = JSMOKES[ARCH].window

    def leaf(path, a):
        if getattr(path[-1], "key", None) not in ("k", "v"):
            return a
        cap, have = min(S, window), a.shape[2]
        if have == cap and n > cap:
            a = jnp.roll(a, (n - cap) % cap, axis=2)
        return jnp.pad(a, [(0, 0), (0, 0), (0, cap - have)]
                       + [(0, 0)] * (a.ndim - 3))
    return jax.tree_util.tree_map_with_path(leaf, caches)


def _jax_model():
    jm = dataclasses.replace(jbuild(JSMOKES[ARCH]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    return jm, params


def _reference():
    """JAX's unsharded model: float32 weights, the prefill's logits and
    caches, greedy tokens over the caches handed to decode, the loss and
    its gradients."""
    jm, params = _jax_model()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, JSMOKES[ARCH].vocab, (B, T)).astype(np.int64)
    jt = jnp.asarray(toks, jnp.int32)
    logits, caches = jm.prefill(params, {"tokens": jt})
    grown = _handed(caches, T, T + STEPS)
    tok = jnp.argmax(logits[:, 0], -1)[:, None]
    greedy = [tok]
    for s in range(STEPS):
        lg, grown = jm.decode_step(params, grown, tok, T + s)
        tok = jnp.argmax(lg[:, 0], -1)[:, None]
        greedy.append(tok)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {"tokens": jt, "labels": jt})
    return {"params": jax.tree.map(np.asarray, params), "tokens": toks,
            "logits": np.asarray(logits), "caches": caches,
            "greedy": np.asarray(jnp.concatenate(greedy, 1)),
            "loss": float(loss), "grads": grads}


def _seq_reference(params):
    """Each of ``SEQ_LENGTHS``' prompts alone through JAX's model: its
    prefill handed to a decode cache of ``SEQ_S`` slots and ``STEPS``
    greedy steps at its own scalar position. Returns the prompts, each
    call's logits and the greedy tokens (rows joined) and the final
    caches (rows joined)."""
    jm, _ = _jax_model()
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, JSMOKES[ARCH].vocab, n).astype(np.int64)
               for n in SEQ_LENGTHS]
    step = jax.jit(jm.decode_step)
    logits, greedy, caches = [], [], []
    for toks in prompts:
        lg, c = jm.prefill(params, {"tokens": jnp.asarray(toks[None],
                                                          jnp.int32)})
        c = _handed(c, len(toks), SEQ_S)
        lgs, tok = [lg], jnp.argmax(lg[:, 0], -1)[:, None]
        picks = [tok]
        for s in range(STEPS):
            lg, c = step(params, c, tok, len(toks) + s)
            lgs.append(lg)
            tok = jnp.argmax(lg[:, 0], -1)[:, None]
            picks.append(tok)
        logits.append([np.asarray(x, np.float32) for x in lgs])
        greedy.append(np.asarray(jnp.concatenate(picks, 1)))
        caches.append(c)
    return {"prompts": prompts,
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
        jobs = [(ARCH, ref["params"], ref["tokens"])]
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
               "same", {})
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


def test_rglru_tp_prefill_logits_match_jax(run):
    _, ref, got = run
    _close(got["logits"], ref["logits"])


def test_rglru_tp_logical_caches_match_jax(run):
    """The ranks' channels of each RG-LRU block's ``conv`` and ``state``
    joined, and the window's keys every rank holds (MQA), are JAX's."""
    _, ref, got = run
    _tree_close(got["caches"], ref["caches"])


def test_rglru_tp_greedy_tokens_match_jax(run):
    _, ref, got = run
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])


def test_rglru_tp_loss_and_every_gradient_match_jax(run):
    _, ref, got = run
    assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    tree = to_jax_tree({n: torch.from_numpy(g)
                        for n, g in got["grads"].items()})
    want = jax.tree.map(np.asarray, ref["grads"])
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(_close, tree, want)


def test_windowed_ring_seq_sharded_logits_match_jax(seq):
    ref, got = seq
    assert got["local_slots"] == JSMOKES[ARCH].window // 2
    for g, w in zip(got["logits"], ref["logits"]):
        _close(g, w)


def test_windowed_ring_seq_sharded_greedy_tokens_match_jax(seq):
    ref, got = seq
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])


def test_windowed_ring_seq_sharded_cache_matches_jax(seq):
    """The ring joined over its slots and the RG-LRU leaves over their
    channels after the steps: JAX's caches, row by row."""
    ref, got = seq
    _tree_close(got["caches"], ref["caches"])


# -------------------------------------------------- one process, no spawn
def test_rglru_placements_and_gradient_sums():
    """At a model axis of 2: the projections, gates and decay hold the
    rank's 64 of 128 channels (8 of 16 gate blocks), ``w_out_rg`` its rows,
    the conv taps stay whole and sum their gradient over "model" (and
    "data"); mamba2's SSD mixer, whole on every rank, sums its conv
    taps' over "data" only. The caches hold the rank's channels."""
    cfg = SMOKES[ARCH]
    ctx = ShardCtx(mesh=ranks.fake_mesh(2, 2))
    model = build_model(cfg, device="cpu", dtype=torch.float32, ctx=ctx)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    d, w = cfg.d_model, cfg.rglru_width
    mix = "seg0.0.0.mix"
    assert shapes[f"{mix}.w_x.w"] == shapes[f"{mix}.w_gate_branch.w"] == \
        (d, w // 2)
    assert shapes[f"{mix}.w_out_rg.w"] == (w // 2, d)
    assert shapes[f"{mix}.gate_in"] == (8, w // 16, w // 16)
    assert shapes[f"{mix}.a_param"] == (w // 2,)
    assert shapes[f"{mix}.conv"] == (cfg.ssm_conv, w)
    splits = model_splits(model)
    for name in (f"{mix}.conv", "seg0.0.1.mix.conv"):
        assert grad_sum_axes(name, splits[name], cfg, ctx) == \
            ("data", "model")
    for name in (f"{mix}.a_param", f"{mix}.w_x.w", f"{mix}.gate_rec"):
        assert grad_sum_axes(name, splits[name], cfg, ctx) == ("data",)
    cache = model.init_cache(2, 40)[0]
    assert tuple(cache[0]["mix"]["conv"].shape) == (1, 2, cfg.ssm_conv - 1,
                                                    w // 2)
    assert tuple(cache[1]["mix"]["state"].shape) == (1, 2, w // 2)
    m2 = SMOKES["mamba2-1.3b"]
    mamba = build_model(m2, device="cpu", dtype=torch.float32, ctx=ctx)
    ssd = model_splits(mamba)
    summed = [n for n in ssd if ".mix." in n and "model" in
              grad_sum_axes(n, ssd[n], m2, ctx)]
    assert "seg0.0.0.mix.conv" in ssd and summed == []


def test_rglru_a_model_axis_not_dividing_the_gate_blocks_raises():
    """RG-LRU's 16 gate blocks over 3 ranks: refused."""
    with pytest.raises(ValueError, match="divide RG-LRU's 16 gate blocks"):
        build_model(SMOKES[ARCH], device="cpu",
                    ctx=ShardCtx(mesh=ranks.fake_mesh(1, 3)))


def test_rglru_shard_weights_are_blocks_of_the_logical_ones():
    """One seed gives every mesh the same logical weights: a rank's
    ``a_param`` (drawn as a linspace of the whole width) and gates are its
    blocks of the unsharded model's."""
    cfg = SMOKES[ARCH]
    whole = build_model(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    mix = whole.seg0[0][0].mix
    w = cfg.rglru_width
    for index in range(2):
        mesh = ranks.fake_mesh(1, 2)
        mesh.coord = lambda axis, i=index: i if axis == "model" else 0
        part = build_model(cfg, device="cpu", dtype=torch.float32,
                           ctx=ShardCtx(mesh=mesh),
                           generator=torch.Generator().manual_seed(0))
        pm = part.seg0[0][0].mix
        lo = index * w // 2
        assert pm.cols == lo
        assert torch.equal(pm.a_param, mix.a_param[lo:lo + w // 2])
        assert torch.equal(pm.gate_in, mix.gate_in[index * 8:index * 8 + 8])
        assert torch.equal(pm.w_x.w, mix.w_x.w[:, lo:lo + w // 2])
        assert torch.equal(pm.conv, mix.conv)
