"""Tensor parallelism of MLA (smoke deepseek-v3: 4 heads, 2 a rank at a
model axis of 2; a dense first layer, then routed experts with classic EP
over "model"; the MTP head) held to the JAX package's unsharded model on
the CPU at the meshes (1, 2) and (2, 2), each rank a process over gloo
(``launch.mesh.spawn``). ``wq_b``, ``wk_b`` and ``wv_b`` hold the rank's
heads, ``wo`` its rows; ``wq_a``, ``q_norm``, ``wkv_a``, ``kv_norm`` and
``mtp_proj`` stay whole (JAX's ``_REPL``), their partial gradients summed
over "model". The same converted float32 weights on both sides; the
prefill's last logits and latent caches, 3 greedy tokens, the loss with
the MTP term and every logical gradient, within 1e-5 of each tensor's
largest value, as ``tests/test_torch_sharded_dense.py``. The prompts are
15 tokens: an odd length the model axis does not divide, so the MoE
layers take EP's replicated branch, which has no capacity (at 16 the
dispatch branch drops 18 pairs past it, and the sharded MoE is then not
the unsharded one; those drops are held to JAX's EP body in
``tests/test_torch_sharded_moe.py``). Every run asserts that none
dropped."""
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
ARCH = "deepseek-v3-671b"
MESHES = ((1, 2), (2, 2))
B, T, STEPS = 4, 15, 3


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _reference():
    """JAX's unsharded model: float32 weights, the prefill's logits and
    latent caches, greedy tokens, the loss (MTP term included) and its
    gradients."""
    jm = dataclasses.replace(jbuild(JSMOKES[ARCH]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, JSMOKES[ARCH].vocab, (B, T)).astype(np.int64)
    labels2 = np.roll(toks, -1, axis=1)
    jt = jnp.asarray(toks, jnp.int32)
    logits, caches = jm.prefill(params, {"tokens": jt})
    grown = jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, 0), (0, STEPS), (0, 0)]), caches)
    tok = jnp.argmax(logits[:, 0], -1)[:, None]
    greedy = [tok]
    for s in range(STEPS):
        lg, grown = jm.decode_step(params, grown, tok, T + s)
        tok = jnp.argmax(lg[:, 0], -1)[:, None]
        greedy.append(tok)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {"tokens": jt, "labels": jt,
                 "labels2": jnp.asarray(labels2, jnp.int32)})
    return {"params": jax.tree.map(np.asarray, params), "tokens": toks,
            "labels2": labels2, "logits": np.asarray(logits),
            "caches": caches, "greedy": np.asarray(jnp.concatenate(greedy, 1)),
            "loss": float(loss), "grads": grads}


_CACHE = {}


@pytest.fixture(params=MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def run(request, tmp_path_factory):
    mesh = request.param
    if "ref" not in _CACHE:
        _CACHE["ref"] = _reference()
    ref = _CACHE["ref"]
    if mesh not in _CACHE:
        data, m = mesh
        pg = tmp_path_factory.mktemp("pg") / "store"
        jobs = [(ARCH, ref["params"], ref["tokens"], ref["labels2"])]
        _CACHE[mesh] = spawn(ranks.serve_and_grads, data * m,
                             (m, jobs, STEPS),
                             init_method=f"file://{pg}")[0][0]
    got = _CACHE[mesh]
    assert got["dropped"] == 0
    return mesh, ref, got


def test_mla_tp_prefill_logits_match_jax(run):
    _, ref, got = run
    _close(got["logits"], ref["logits"])


def test_mla_tp_latent_caches_match_jax(run):
    """Every rank holds the whole latent cache (``c``, ``kr``)."""
    _, ref, got = run
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref["caches"]):
        t = got["caches"]
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        _close(t, leaf)


def test_mla_tp_greedy_tokens_match_jax(run):
    _, ref, got = run
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])


def test_mla_tp_loss_and_every_gradient_match_jax(run):
    _, ref, got = run
    assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    tree = to_jax_tree({n: torch.from_numpy(g)
                        for n, g in got["grads"].items()})
    want = jax.tree.map(np.asarray, ref["grads"])
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(_close, tree, want)


# -------------------------------------------------- one process, no spawn
def test_mla_placements_and_gradient_sums():
    """At a model axis of 2: the up-projections hold the rank's 2 heads,
    ``wo`` its rows, the bottleneck, norms and ``mtp_proj`` stay whole;
    the whole ones that feed the heads sum their gradients over "model"
    (and "data"), ``mtp_proj`` over "data" only."""
    cfg = SMOKES[ARCH]
    ctx = ShardCtx(mesh=ranks.fake_mesh(2, 2))
    model = build_model(cfg, device="cpu", dtype=torch.float32, ctx=ctx)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    h, dn, dr, dv = (cfg.n_heads // 2, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    mix = "seg0.0.0.mix"
    assert shapes[f"{mix}.wq_b.w"] == (cfg.q_lora_rank, h * (dn + dr))
    assert shapes[f"{mix}.wk_b.w"] == (cfg.kv_lora_rank, h * dn)
    assert shapes[f"{mix}.wv_b.w"] == (cfg.kv_lora_rank, h * dv)
    assert shapes[f"{mix}.wo.w"] == (h * dv, cfg.d_model)
    assert shapes[f"{mix}.wq_a.w"] == (cfg.d_model, cfg.q_lora_rank)
    assert shapes[f"{mix}.wkv_a.w"] == (cfg.d_model,
                                        cfg.kv_lora_rank + dr)
    assert shapes["mtp_proj.w"] == (2 * cfg.d_model, cfg.d_model)
    assert shapes["mtp_layer.0.mix.wk_b.w"] == (cfg.kv_lora_rank, h * dn)
    splits = model_splits(model)
    for leaf in ("wq_a.w", "q_norm.g", "wkv_a.w", "kv_norm.g"):
        for name in (f"{mix}.{leaf}", f"mtp_layer.0.mix.{leaf}"):
            assert grad_sum_axes(name, splits[name], cfg, ctx) == \
                ("data", "model")
    assert grad_sum_axes("mtp_proj.w", splits["mtp_proj.w"], cfg,
                         ctx) == ("data",)
    assert grad_sum_axes(f"{mix}.wq_b.w", splits[f"{mix}.wq_b.w"], cfg,
                         ctx) == ("data",)


def test_mla_heads_the_model_axis_does_not_divide_raise():
    """JAX pads no MLA head: 3 ranks do not divide the smoke's 4 heads."""
    with pytest.raises(ValueError, match="do not divide MLA's 4 heads"):
        build_model(SMOKES[ARCH], device="cpu",
                    ctx=ShardCtx(mesh=ranks.fake_mesh(1, 3)))
