"""The port's expert-parallel MoE layer held to the JAX package's on the
CPU: the dispatch branch of each rank, run over gloo in spawned processes
(``repro_torch.launch.mesh.spawn``), against JAX's ``_moe_ep_body`` under
``jax.vmap`` with a named axis, for EP over ("model",) at (1, 2) and over
("data", "model") at (2, 2), with a balanced router and a skewed one whose
pairs drop past the capacity; the replicated (decode) branch against
JAX's ``body_dec`` under vmap; the branch ``moe_apply`` picks; and the
one-process emulation of both that ``chip_smoke.py``'s phase 6b holds the
card's sharded runs to (``chip_smoke.ep_emulation``) against the same
references.

JAX's two-axis EP runs here as one named axis of data x model ranks,
row-major: the same group in the same order as ("data", "model") (jax
0.9's batching of ``all_to_all`` refuses a tuple of vmapped axes).
``body_dec`` is a closure inside JAX's ``moe_apply``; ``_body_dec`` below
is its code, on JAX's ``_route``, ``_expert_ffn`` and ``_axis_index``.

One difference, where pairs drop: JAX's body scatters a dropped pair into
slot (0, 0) of its send buffer with zeros (``safe_d``/``safe_p``), after
the pair that holds that slot, and the last write wins, so JAX also loses
the first pair bound for shard 0 whenever a later pair drops. The port
drops only the pairs past the capacity. ``_clobbered`` finds that pair in
JAX's own routing and the test adds its gated expert output back to JAX's
result before comparing (ROADMAP queue 3). Tolerance 1e-5 of the largest
value: float32 on both sides, summed in other orders."""
import functools
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import blocks as jblocks
from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import spawn
from repro_torch.models import blocks

import _sharded_ranks as ranks

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCH = "deepseek-moe-16b"
TOL = 1e-5
CF = blocks.CAPACITY_FACTOR          # JAX moe_apply's default, 1.25


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _layer(seed=0):
    cfg = SMOKES[ARCH]
    E, d, F = cfg.n_experts, cfg.d_model, cfg.d_expert
    rng = np.random.default_rng(seed)

    def w(*shape, fan):
        return (rng.normal(size=shape) * fan ** -0.5).astype(np.float32)
    return {"router": w(d, E, fan=d), "w_in": w(E, d, F, fan=d),
            "w_gate": w(E, d, F, fan=d), "w_out": w(E, F, d, fan=F)}


def _tokens(shape, seed, skew=0.0, layer=None):
    """Normal tokens; with ``skew``, each also moved along the router's
    columns of experts 0 and 1, so most pick both and shard 0 (which holds
    both at an EP of 2 or 4) overflows."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if skew:
        u = layer["router"][:, 0] + layer["router"][:, 1]
        x = x + skew * u / np.linalg.norm(u)
    return x.astype(np.float32)


def _banks(layer, ep):
    return [jnp.asarray(layer[n].reshape(ep, -1, *layer[n].shape[1:]))
            for n in ("w_in", "w_gate", "w_out")]


def _jax_dispatch(layer, xs):
    """JAX ``_moe_ep_body`` on each shard's tokens ``xs`` [ep, N, D]."""
    ep = xs.shape[0]
    body = functools.partial(jblocks._moe_ep_body, cfg=JSMOKES[ARCH],
                             axis="ep", capacity_factor=CF)
    f = jax.vmap(body, in_axes=(0, None, 0, 0, 0), axis_name="ep")
    return np.asarray(f(jnp.asarray(xs), jnp.asarray(layer["router"]),
                        *_banks(layer, ep)))


def _clobbered(layer, xs):
    """For each shard, the gated expert output JAX's body loses to its
    scatter of dropped pairs into slot (0, 0): zero where nothing drops
    after the first pair bound for shard 0. Also returns the pairs that
    drop."""
    cfg = JSMOKES[ARCH]
    ep, N, D = xs.shape
    K, E_loc = cfg.top_k, cfg.n_experts // ep
    cap = max(1, int(math.ceil(N * K / ep * CF)))
    fix, dropped = np.zeros_like(xs), 0
    for s in range(ep):
        gates, idx = jblocks._route(jnp.asarray(xs[s]),
                                    jnp.asarray(layer["router"]), K)
        gates, idx = np.asarray(gates).reshape(-1), np.asarray(idx).reshape(-1)
        dest = idx // E_loc
        pos = np.array([(dest[:i] == dest[i]).sum() for i in range(N * K)])
        late = np.nonzero(pos >= cap)[0]
        dropped += len(late)
        first = np.nonzero(dest == 0)[0]
        if len(late) and len(first) and late[-1] > first[0]:
            i = first[0]
            e = int(idx[i])
            h = jblocks._expert_ffn(
                jnp.asarray(layer["w_in"][e:e + 1]),
                jnp.asarray(layer["w_gate"][e:e + 1]),
                jnp.asarray(layer["w_out"][e:e + 1]),
                jnp.asarray(xs[s, i // K][None]), jnp.asarray([1], jnp.int32))
            fix[s, i // K] += gates[i] * np.asarray(h)[0]
    return fix, dropped


def _body_dec(xf, router, w_in, w_gate, w_out, *, axis):
    """JAX ``moe_apply``'s ``body_dec`` (its decode branch), on a shard."""
    cfg = JSMOKES[ARCH]
    N, K = xf.shape[0], cfg.top_k
    E_loc = w_in.shape[0]
    gates, idx = jblocks._route(xf, router, K)
    lo = jblocks._axis_index(axis) * E_loc
    local = (idx >= lo) & (idx < lo + E_loc)
    flat_local = local.reshape(-1)
    e_loc = jnp.where(flat_local, (idx - lo).reshape(-1), E_loc)
    xin = jnp.where(flat_local[:, None], jnp.repeat(xf, K, axis=0), 0.0)
    order = jnp.argsort(e_loc)
    gs = jnp.bincount(e_loc, length=E_loc + 1)
    pad = [jnp.concatenate([w, jnp.zeros_like(w[:1])], 0)
           for w in (w_in, w_gate, w_out)]
    y_sorted = jblocks._expert_ffn(*pad, xin[order], gs)
    y = jnp.zeros_like(xin).at[order].set(y_sorted)
    wgt = gates.reshape(-1)[:, None].astype(y.dtype)
    out = jnp.zeros_like(xf).at[jnp.arange(N * K) // K].add(y * wgt)
    return jax.lax.psum(out, axis)


def _jax_replicated(layer, x, ep):
    """``body_dec`` on every shard of an EP group over the same tokens
    ``x`` [N, D]; every shard's result is the group's sum."""
    f = jax.vmap(functools.partial(_body_dec, axis="ep"),
                 in_axes=(None, None, 0, 0, 0), axis_name="ep")
    out = np.asarray(f(jnp.asarray(x), jnp.asarray(layer["router"]),
                       *_banks(layer, ep)))
    assert all(np.array_equal(out[0], o) for o in out[1:])
    return out[0]


MESHES = {"classic-1x2": ((1, 2), ("model",)),
          "2d-2x2": ((2, 2), ("data", "model"))}
SKEWS = {"balanced": 0.0, "skewed": 8.0}
N = 12                     # a dispatching rank's tokens
REPLICATED = {"decode": 1, "prefill": 3}     # T the model axis divides not
B = 2                      # a replicated case's rows a data rank
_RUNS = {}


def _inputs(mesh):
    """Each case's tokens: the dispatch cases [data, model, N, D], the
    replicated ones [data, B, T, D]."""
    (data, m), _ = MESHES[mesh]
    d, layer = SMOKES[ARCH].d_model, _layer()
    cases = {("dispatch", k): _tokens((data, m, N, d), 1, v, layer)
             for k, v in SKEWS.items()}
    cases.update({(mode, T): _tokens((data, B, T, d), 2, 2.0, layer)
                  for mode, T in REPLICATED.items()})
    return cases


def _ranks(mesh, tmp_path_factory):
    """Every case of ``mesh`` through the port's ranks, in one spawn."""
    if mesh not in _RUNS:
        (data, m), axes = MESHES[mesh]
        cases = _inputs(mesh)
        pg = tmp_path_factory.mktemp("pg") / "store"
        out = spawn(ranks.ep_layer, data * m, (
            m, axes, _layer(), SMOKES[ARCH],
            [(x, key[0]) for key, x in cases.items()]),
            init_method=f"file://{pg}")[0]
        _RUNS[mesh] = dict(zip(cases, out))
    return _RUNS[mesh]


@pytest.mark.parametrize("skew", sorted(SKEWS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dispatch_matches_jax_ep_body(tmp_path_factory, mesh, skew):
    """Each rank's tokens through the dispatch, the experts of their shard
    and the combine, over gloo, against JAX's body on the same shard; the
    pairs dropped and the bytes sent."""
    (data, m), axes = MESHES[mesh]
    cfg, layer = SMOKES[ARCH], _layer()
    x = _inputs(mesh)[("dispatch", skew)]
    ep = data * m if "data" in axes else m
    # the EP groups: every shard for ("data", "model"), a data row's for
    # ("model",)
    groups = x.reshape(-1, ep, N, cfg.d_model)
    want, fixes, drops = [], [], 0
    for g in groups:
        want.append(_jax_dispatch(layer, g))
        fix, dropped = _clobbered(layer, g)
        fixes.append(fix)
        drops += dropped
    want = (np.stack(want) + np.stack(fixes)).reshape(data * m, N, -1)
    out, dropped, sent, branches = _ranks(mesh, tmp_path_factory)[
        ("dispatch", skew)]
    assert int(dropped.sum()) == drops and (drops > 0 or not SKEWS[skew])
    _close(out, want)
    assert branches == {"dispatch": 1}
    cap = max(1, math.ceil(N * cfg.top_k / ep * CF))
    assert sent == (ep - 1) * cap * (2 * cfg.d_model * 4 + 8)


@pytest.mark.parametrize("mode", sorted(REPLICATED))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_replicated_branch_matches_jax_body_dec(tmp_path_factory, mesh,
                                                mode):
    """T the model axis does not divide: the tokens replicated in the EP
    domain (gathered over "data" for ("data", "model")), each rank's
    experts' share summed over the EP axes; ``moe_apply`` takes this
    branch."""
    (data, m), axes = MESHES[mesh]
    cfg, layer = SMOKES[ARCH], _layer()
    T = REPLICATED[mode]
    x = _inputs(mesh)[(mode, T)]
    if "data" in axes:
        y = _jax_replicated(layer, x.reshape(-1, cfg.d_model), data * m)
        want = y.reshape(data, B, T, -1)
    else:
        want = np.stack([_jax_replicated(layer, xd.reshape(-1, cfg.d_model),
                                         m).reshape(B, T, -1) for xd in x])
    out, dropped, sent, branches = _ranks(mesh, tmp_path_factory)[(mode, T)]
    assert branches == {"replicated": 1}
    assert int(dropped.sum()) == 0 and sent == 0
    # every model rank of a data row holds that row's result
    out = out.reshape(data, m, B, T, -1)
    for j in range(m):
        _close(out[:, j], want)


def _module(layer):
    cfg = SMOKES[ARCH]
    p = blocks.MoE(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for n, v in layer.items():
            getattr(p, n).copy_(torch.from_numpy(v))
    p.shared = None
    return p


@pytest.mark.parametrize("skew", sorted(SKEWS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_emulation_matches_jax(mesh, skew):
    """``chip_smoke.ep_emulation`` of (data, model) on the logical batch: the
    dispatch branch (T the model axis divides) against JAX's body on each
    virtual shard's tokens, and the replicated branch against
    ``body_dec``; the pairs dropped counted as the ranks count them."""
    (data, m), axes = MESHES[mesh]
    cfg, layer = SMOKES[ARCH], _layer()
    p = _module(layer)
    ep = data * m if "data" in axes else m
    B, T = 2 * data, 4 * m
    x = _tokens((B, T, cfg.d_model), 3, SKEWS[skew], layer)
    got, dropped = chip_smoke.ep_emulation(p, torch.from_numpy(x), cfg,
                                           "prefill", (data, m), axes)
    got = got.numpy()
    # shard (d, j): data rows d, sequence block j
    shards = x.reshape(data, B // data, m, T // m, -1).transpose(0, 2, 1, 3, 4)
    shards = shards.reshape(data * m // ep, ep, -1, cfg.d_model)
    want = np.stack([_jax_dispatch(layer, g) + _clobbered(layer, g)[0]
                     for g in shards])
    drops = sum(_clobbered(layer, g)[1] for g in shards)
    want = want.reshape(data, m, B // data, T // m, -1).transpose(0, 2, 1, 3, 4)
    _close(got, want.reshape(B, T, -1))
    assert int(dropped) == drops and (drops > 0 or
                                                not SKEWS[skew])
    # the replicated branch: T = 1
    x1 = x[:, :1]
    got = chip_smoke.ep_emulation(p, torch.from_numpy(x1), cfg, "decode",
                                  (data, m), axes)[0].numpy()
    if "data" in axes:
        want = _jax_replicated(layer, x1.reshape(-1, cfg.d_model), ep)
    else:
        want = np.concatenate([_jax_replicated(
            layer, xd.reshape(-1, cfg.d_model), ep)
            for xd in x1.reshape(data, -1, cfg.d_model)])
    _close(got, want.reshape(B, 1, -1))


def test_emulation_of_one_rank_is_the_local_moe():
    """A mesh of one EP rank (and experts EP does not divide) emulates the
    single-device MoE exactly."""
    cfg, layer = SMOKES[ARCH], _layer()
    p = _module(layer)
    x = torch.from_numpy(_tokens((2, 6, cfg.d_model), 4))
    want = blocks.moe_apply(p, x, cfg=cfg, mode="prefill")
    for mesh, axes in (((2, 1), ("model",)), ((1, 3), ("model",))):
        got, _ = chip_smoke.ep_emulation(p, x, cfg, "prefill", mesh, axes)
        assert torch.equal(got, want)
