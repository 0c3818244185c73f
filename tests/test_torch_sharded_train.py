"""Sharded training of the port held to the JAX package on the CPU, each
rank a process over gloo (``launch.mesh.spawn``): two train steps of smoke
smollm-360m at (2, 2) (data and tensor parallel) and one of smoke
mamba2-1.3b at (2, 1) (data parallel) against JAX's ``train_step``
unsharded on the same float32 weights and batches (the loss, the logical
gradient's norm, every updated parameter and moment); checkpoints of
logical arrays across meshes and packages (written at (1, 2) and at
(2, 2), restored at (1, 1) bit for bit, the first by JAX too; written at
(1, 1), resumed at (1, 2));
``launch.train.run(model_par=2)`` in a 2-process group; and what this
slice does not cover refusing to run.

Tolerances as tests/test_torch_train.py's: 2e-5 of each leaf's largest
value; a parameter also moves by what that tolerance in its gradient can
move Adam's steps (``_state_close``)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.launch.train import synthetic_batch as jsynthetic_batch
from repro.models.lm import build_model as jbuild
from repro.training import checkpoint as jckpt
from repro.training.optim import AdamWConfig as JAdamWConfig
from repro.training.trainer import init_train_state as jinit_train_state
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.convert import to_jax_tree
from repro_torch.models.sharding import ShardCtx
from repro_torch.training import (AdamWConfig, adamw_init, make_train_step,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training.trainer import TrainState

import _sharded_ranks as ranks

TOL = 2e-5
KEY = jax.random.PRNGKey(0)
LR = 1e-2
BATCH, SEQ = 4, 24


def _jax(arch):
    jm = dataclasses.replace(jbuild(JSMOKES[arch]), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(KEY))
    return jm, params


def _tree(d):
    return to_jax_tree({n: torch.from_numpy(v) for n, v in d.items()})


def _jax_steps(arch, first, states, start=None):
    """JAX's ``train_step`` from each state the ranks started a step from
    (``start`` for the first, a logical state or None for JAX's init) on
    that step's batch. Returns each step's (loss, grad norm) and state:
    each of the ranks' steps is held to JAX's from the same state."""
    jm, params = _jax(arch)
    cfg = JAdamWConfig(lr=LR, warmup=1)
    init = jinit_train_state(jm, KEY, cfg)._replace(params=params)
    fn = jax.jit(jmake_train_step(jm, cfg))
    metrics, out = [], []
    for i, before in enumerate([start] + states[:-1]):
        s = first + i
        state = init if before is None else init._replace(
            params=_tree(before["params"]), step=jnp.int32(s),
            opt=init.opt._replace(step=jnp.int32(s), m=_tree(before["m"]),
                                  v=_tree(before["v"])))
        state, met = fn(state, jsynthetic_batch(jm.cfg, BATCH, SEQ, seed=0,
                                                step=s))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
        out.append(state)
    return metrics, out


def _leaf_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _state_close(logical, jstate):
    """The ranks' logical parameters and moments after a step against
    JAX's after the same step from the same state. A parameter moved by
    Adam's step ``lr m^/(sqrt(v^) + eps)`` is held to the file's tolerance
    plus what an error of ``delta`` (the gradient tolerance: TOL of the
    leaf's largest |m^|) in its gradient moves that step, ``lr delta /
    (sqrt(v^) + eps)``, at most ``lr``: an element whose gradient is within
    a few ``delta`` of 0 is ill-conditioned, one with a larger one is
    not."""
    t = int(jstate.step)
    b1c, b2c = 1 - 0.9 ** t, 1 - 0.95 ** t

    def param_close(got, want, m, v):
        got, want = np.asarray(got), np.asarray(want)
        mhat, vhat = np.abs(np.asarray(m)) / b1c, np.asarray(v) / b2c
        delta = TOL * max(float(mhat.max()), 1e-30)
        slack = LR * np.minimum(1.0, delta / (np.sqrt(vhat) + 1e-8))
        scale = max(float(np.abs(want).max()), 1e-30)
        assert (np.abs(got - want) <= TOL * scale + slack).all()

    jax.tree.map(param_close, _tree(logical["params"]), jstate.params,
                 jstate.opt.m, jstate.opt.v)
    jax.tree.map(_leaf_close, _tree(logical["m"]), jstate.opt.m)
    jax.tree.map(_leaf_close, _tree(logical["v"]), jstate.opt.v)


def _steps_close(arch, got, first=0, start=None):
    """The ranks' (metrics, states) against JAX's steps."""
    metrics, states = got
    want, jstates = _jax_steps(arch, first, states, start)
    assert len(metrics) == len(want)
    for (gl, gn), (jl, jn) in zip(metrics, want):
        assert gl == pytest.approx(jl, rel=1e-5)
        assert gn == pytest.approx(jn, rel=1e-5)
    for logical, jstate in zip(states, jstates):
        _state_close(logical, jstate)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One 2-process group for: a data parallel step of mamba2 at (2, 1);
    a checkpoint written by a (1, 1) run, resumed at (1, 2) for a step and
    written again; and ``run(model_par=2)``."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    _, params = _jax("smollm-360m")
    params = jax.tree.map(np.asarray, params)
    # the (1, 1) run: one step, saved at step 1
    tm = from_jax_params(params, build_model(SMOKES["smollm-360m"],
                                             device="cpu",
                                             dtype=torch.float32))
    tm.requires_grad_(True)
    tp = dict(tm.named_parameters())
    opt = AdamWConfig(lr=LR, warmup=1)
    state = TrainState(tp, adamw_init(tp, opt), 0)
    from repro_torch.launch.train import synthetic_batch
    state, _ = make_train_step(tm, opt)(state, synthetic_batch(
        tm.cfg, BATCH, SEQ, seed=0, step=0, device="cpu"))
    save_checkpoint(str(ckpt / "a"), 1, state)
    _, mparams = _jax("mamba2-1.3b")
    jobs = [(1, "mamba2-1.3b", jax.tree.map(np.asarray, mparams), 1, BATCH,
             SEQ, LR, "", 0),
            (2, "smollm-360m", params, 1, BATCH, SEQ, LR, str(ckpt / "a"), 1)]
    pg = tmp_path_factory.mktemp("pg")
    trained = spawn(ranks.train_steps, 2, (jobs,),
                    init_method=f"file://{pg}/a")[0]
    launched = spawn(ranks.launcher, 2, (str(ckpt / "run"),),
                     init_method=f"file://{pg}/b")
    return {"ckpt": ckpt, "params": params, "mamba2": trained[0],
            "resumed": trained[1], "run": launched}


def _restored_is(ckpt, step, logical):
    """The checkpoint of ``step`` restored at (1, 1) holds ``logical``'s
    parameters and moments bit for bit. Returns the restored state."""
    model = build_model(SMOKES["smollm-360m"], device="cpu",
                        dtype=torch.float32)
    model.requires_grad_(True)
    tp = dict(model.named_parameters())
    restored = restore_checkpoint(ckpt, step,
                                  TrainState(tp, adamw_init(tp), 0))
    assert restored.step == restored.opt.step == step
    for field, tensors in (("params", restored.params),
                           ("m", restored.opt.m), ("v", restored.opt.v)):
        for n, t in tensors.items():
            assert np.array_equal(t.detach().numpy(), logical[field][n]), n
    return restored


def test_two_steps_at_2x2_match_jax(tmp_path):
    """Data parallel over 2 and tensor parallel over 2: every rank's rows
    of each batch, the loss the whole batch's mean, the gradients summed
    over "data" (and a replicated KV projection's over "model"), the norm
    the logical gradient's; the checkpoint the ranks write after the last
    step (each tensor gathered to rank 0 alone) is the logical state."""
    _, params = _jax("smollm-360m")
    ckpt = str(tmp_path / "ckpt")
    job = (2, "smollm-360m", jax.tree.map(np.asarray, params), 2, BATCH,
           SEQ, LR, ckpt, 0)
    got = spawn(ranks.train_steps, 4, ([job],),
                init_method=f"file://{tmp_path}/pg")[0][0]
    assert len(got[1]) == 2
    _steps_close("smollm-360m", got)
    _restored_is(ckpt, 2, got[1][-1])


def test_data_parallel_mamba2_step_matches_jax(world2):
    """mamba2's smoke at (2, 1): its SSD mixers replicated, the batch split
    over "data"."""
    _steps_close("mamba2-1.3b", world2["mamba2"])


def test_checkpoint_moves_between_meshes_and_packages(world2):
    """A (1, 1) checkpoint resumed at (1, 2), stepped once and written
    again as logical arrays: restored at (1, 1) bit for bit to what the
    ranks held, and by JAX bit for bit; the step matches JAX's second
    step."""
    ckpt = str(world2["ckpt"] / "a")
    model = build_model(SMOKES["smollm-360m"], device="cpu",
                        dtype=torch.float32)
    model.requires_grad_(True)
    tp = dict(model.named_parameters())
    first = restore_checkpoint(ckpt, 1, TrainState(tp, adamw_init(tp), 0))
    start = {k: {n: t.detach().numpy().copy() for n, t in ts.items()}
             for k, ts in (("params", first.params), ("m", first.opt.m),
                           ("v", first.opt.v))}
    _steps_close("smollm-360m", world2["resumed"], first=1, start=start)
    restored = _restored_is(ckpt, 2, world2["resumed"][1][-1])
    jm, _ = _jax("smollm-360m")
    abstract = jax.tree.map(  # the float32 arrays the ranks trained
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32)
        if a.dtype == jnp.bfloat16 else a,
        jax.eval_shape(lambda k: jinit_train_state(jm, k), KEY))
    jrestored = jckpt.restore_checkpoint(ckpt, 2, abstract)
    for a, b in zip(jax.tree.leaves(jrestored.params),
                    jax.tree.leaves(to_jax_tree(restored.params))):
        assert np.array_equal(np.asarray(a), b)


def test_run_with_model_par_2_trains_and_resumes(world2):
    """``run(model_par=2)`` in a 2-process group returns (state, losses)
    with the rank's shards; its checkpoint resumes the run, the replayed
    step bit for bit; both ranks report the same losses."""
    (name, step, losses, more, shapes), other = world2["run"]
    assert name == "TrainState" and step == 3
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert more[0] == losses[2] and len(more) == 2
    assert other[2:4] == (losses, more)
    cfg = SMOKES["smollm-360m"]
    assert shapes["embed"] == (cfg.vocab // 2, cfg.d_model)
    assert shapes["seg0.0.0.mix.wq.w"] == (cfg.d_model, 8 * cfg.hd)
    assert shapes["seg0.0.0.mix.wk.w"] == (cfg.d_model, cfg.n_kv * cfg.hd)


def _fake_mesh(data, model):
    """Enough of a mesh for a refusal that comes before any collective."""
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 coord=lambda axis: 0, backend="gloo")


@pytest.mark.parametrize("flag", ["zero3", "kv_seq_shard"])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="queue 1 #8"):
        ShardCtx(**{flag: True})


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "deepseek-v3-671b", "seamless-m4t-medium"])
def test_tensor_parallel_of_uncovered_families_raises(arch):
    """SSM, hybrid, MLA and encoder-decoder models refuse a model axis of
    more than one rank (they run data parallel)."""
    with pytest.raises(NotImplementedError, match="next slice"):
        build_model(SMOKES[arch], device="cpu",
                    ctx=ShardCtx(mesh=_fake_mesh(1, 2)))
