"""The port's sharded models held to the JAX package's unsharded ones on
the CPU: smoke smollm-360m (3 query heads padded to 16 over one KV head,
replicated on every rank) and smoke deepseek-moe-16b (4 MHA heads padded
to 16, split with their KV heads; a dense layer, then routed experts with
classic EP over "model" and a shared one) on the meshes (1, 2), (2, 1)
and (2, 2), each rank a process over gloo (``launch.mesh.spawn``). The
same converted float32 weights on both sides; the prefill's last logits
and caches, 3 greedy tokens (the MoE's decode through the replicated
branch), the loss and every logical gradient, within 1e-5 of each
tensor's largest value.

The sharded MoE equals the single-device one only where no (token,
expert) pair drops past the capacity: every run here asserts that none
did. Drops are held to JAX's EP body in tests/test_torch_sharded_moe.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models.lm import build_model as jbuild
from repro_torch.launch.mesh import spawn
from repro_torch.models.convert import to_jax_tree

import _sharded_ranks as ranks

TOL = 1e-5
ARCHS = ("smollm-360m", "deepseek-moe-16b")
MESHES = ((1, 2), (2, 1), (2, 2))
B, T, STEPS = 4, 16, 3


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _reference(arch):
    """JAX's unsharded model: float32 weights, the prefill's logits and
    caches, greedy tokens, the loss and its gradients."""
    jm = dataclasses.replace(jbuild(JSMOKES[arch]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(
        0, JSMOKES[arch].vocab, (B, T)).astype(np.int64)
    jt = jnp.asarray(toks, jnp.int32)
    logits, caches = jm.prefill(params, {"tokens": jt})
    grown = jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]), caches)
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


_CACHE = {}


def _run(arch, mesh, tmp_path_factory):
    """The JAX reference and the sharded run of ``arch`` on ``mesh``,
    computed once for the file's tests (both models in one spawn a
    mesh)."""
    for a in ARCHS:
        if a not in _CACHE:
            _CACHE[a] = _reference(a)
    if mesh not in _CACHE:
        data, m = mesh
        pg = tmp_path_factory.mktemp("pg") / "store"
        jobs = [(a, _CACHE[a]["params"], _CACHE[a]["tokens"]) for a in ARCHS]
        _CACHE[mesh] = dict(zip(ARCHS, spawn(
            ranks.serve_and_grads, data * m, (m, jobs, STEPS),
            init_method=f"file://{pg}")[0]))
    return _CACHE[arch], _CACHE[mesh][arch]


@pytest.fixture(params=[(a, m) for a in ARCHS for m in MESHES],
                ids=[f"{a}-{m[0]}x{m[1]}" for a in ARCHS for m in MESHES])
def run(request, tmp_path_factory):
    arch, mesh = request.param
    ref, got = _run(arch, mesh, tmp_path_factory)
    if JSMOKES[arch].n_experts:
        assert got["dropped"] == 0
    return arch, mesh, ref, got


def test_prefill_logits_match_jax(run):
    _, _, ref, got = run
    _close(got["logits"], ref["logits"])


def test_prefill_caches_match_jax(run):
    _, _, ref, got = run
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref["caches"]):
        t = got["caches"]
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        _close(t, leaf)


def test_greedy_tokens_match_jax(run):
    arch, mesh, ref, got = run
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])
    if JSMOKES[arch].n_experts and mesh[1] > 1:
        # T divides the model axis at the prefill; a decode token does not
        assert set(got["branches"]) == {"dispatch", "replicated"}


def test_loss_and_every_gradient_match_jax(run):
    _, _, ref, got = run
    assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    tree = to_jax_tree({n: torch.from_numpy(g)
                        for n, g in got["grads"].items()})
    jax.tree.map(_close, tree, jax.tree.map(np.asarray, ref["grads"]))
    assert (jax.tree.structure(tree) ==
            jax.tree.structure(jax.tree.map(np.asarray, ref["grads"])))
