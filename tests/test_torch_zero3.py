"""ZeRO-3 training of the port (``ShardCtx(zero3=True)``, the JAX package's
training layout) held to the JAX package on the CPU, each rank a process
over gloo (``launch.mesh.spawn``): two train steps of smoke smollm-360m and
smoke deepseek-moe-16b at (2, 1) and (2, 2) with zero3, and of smollm on a
(2, 1, 2) mesh over ("pod", "data", "model") whose batch and zero3 axes
are ("pod", "data"), against JAX's unsharded ``train_step`` on the same
float32 weights and batches (tests/test_torch_sharded_train.py's checks:
the loss, the logical gradient's norm, every updated parameter and moment,
2e-5 of each leaf's largest value); the same steps without zero3 on the
same mesh; mamba2's smoke on a model axis at (1, 2) and (2, 2); a
checkpoint written under zero3 restored at (1, 1) bit for bit and by JAX;
a resume bitwise; a rank's resident parameter and moment bytes; and the
collectives a step counts on a dry mesh against those it runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro.training.trainer import init_train_state as jinit_train_state
from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import DryMesh, spawn
from repro_torch.launch.shardings import (grad_sum_axes, model_splits,
                                          shard_batch, shard_state)
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import build_model
from repro_torch.models.convert import to_jax_tree
from repro_torch.models.sharding import ShardCtx
from repro_torch.training import AdamWConfig, adamw_init, make_train_step
from repro_torch.training.trainer import TrainState

import _sharded_ranks as ranks
from test_torch_sharded_train import (BATCH, KEY, LR, SEQ, _jax, _restored_is,
                                      _steps_close)

#: (name, ``_sharded_ranks._ctx`` keywords, arch, steps, checkpoint,
#: restore step) of the jobs the 4 ranks run, in order
JOBS = (
    ("smollm-2x2-z3", dict(model_par=2, zero3=True), "smollm-360m", 2,
     "z3", 0),
    ("smollm-2x2", dict(model_par=2), "smollm-360m", 2, "", 0),
    ("smollm-4x1-z3", dict(model_par=1, zero3=True), "smollm-360m", 2, "",
     0),
    ("smollm-pod-z3", dict(model_par=2, zero3=True, pods=2), "smollm-360m",
     2, "", 0),
    # one step: the second drops pairs past the EP capacity at (2, 2),
    # which the unsharded reference does not
    ("moe-2x2-z3", dict(model_par=2, zero3=True), "deepseek-moe-16b", 1, "",
     0),
    ("moe-4x1-z3", dict(model_par=1, zero3=True), "deepseek-moe-16b", 2, "",
     0),
    ("mamba2-2x2-z3", dict(model_par=2, zero3=True), "mamba2-1.3b", 2, "",
     0),
    # a resume: one step saved, then one more from the checkpoint
    ("resume-a", dict(model_par=1, zero3=True), "smollm-360m", 1, "r", 0),
    ("resume-b", dict(model_par=1, zero3=True), "smollm-360m", 1, "r", 1),
)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The jobs of ``JOBS`` on one 4-process group, and mamba2's smoke at
    (1, 2) on a 2-process group; each job's (metrics, states, report) by
    name."""
    tmp = tmp_path_factory.mktemp("z3")
    params = {a: jax.tree.map(np.asarray, _jax(a)[1])
              for a in ("smollm-360m", "deepseek-moe-16b", "mamba2-1.3b")}
    jobs = [(kw, arch, params[arch], steps, BATCH, SEQ, LR,
             str(tmp / ckpt) if ckpt else "", restore)
            for _, kw, arch, steps, ckpt, restore in JOBS]
    got = spawn(ranks.train_meshes, 4, (jobs,),
                init_method=f"file://{tmp}/pg4")[0]
    out = {name: r for (name, *_), r in zip(JOBS, got)}
    out["mamba2-1x2"] = spawn(ranks.train_meshes, 2, ([(
        dict(model_par=2), "mamba2-1.3b", params["mamba2-1.3b"], 2, BATCH,
        SEQ, LR, "", 0)],), init_method=f"file://{tmp}/pg2")[0][0]
    out["run"] = spawn(ranks.launcher, 4, (str(tmp / "run"), True),
                       init_method=f"file://{tmp}/pg4run")
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("name", ["smollm-2x2-z3", "smollm-4x1-z3",
                                  "smollm-pod-z3", "moe-2x2-z3",
                                  "moe-4x1-z3"])
def test_zero3_steps_match_jax(world4, name):
    """Parameters split over "data" (or ("pod", "data")) by the dim TP
    leaves whole, gathered at each read, their gradients reduce-scattered;
    two steps equal JAX's from the same states."""
    arch, steps = next((a, st) for n, _, a, st, *_ in JOBS if n == name)
    metrics, states, report = world4[name]
    assert len(metrics) == steps and report["dropped"] == 0
    _steps_close(arch, (metrics, states))


def test_zero3_equals_the_same_mesh_without_it(world4):
    """ZeRO-3 changes where the parameters live, not the step: at (2, 2)
    the losses and gradient norms agree to float32 rounding, the moments
    (linear in the gradients) to 1e-5 of each one's largest value; both
    runs' parameters are held to JAX (Adam's step of a gradient near 0 is
    ill-conditioned, ``_state_close``)."""
    z3, plain = world4["smollm-2x2-z3"], world4["smollm-2x2"]
    _steps_close("smollm-360m", plain[:2])
    for (lz, nz), (lp, np_) in zip(z3[0], plain[0]):
        assert lz == pytest.approx(lp, rel=1e-6)
        assert nz == pytest.approx(np_, rel=1e-6)
    for sz, sp in zip(z3[1], plain[1]):
        for field in ("m", "v"):
            for n, t in sz[field].items():
                want = sp[field][n]
                scale = max(float(np.abs(want).max()), 1e-30)
                np.testing.assert_allclose(t, want, rtol=0,
                                           atol=1e-5 * scale + 1e-7)


@pytest.mark.parametrize("name", ["mamba2-1x2", "mamba2-2x2-z3"])
def test_mamba2_on_a_model_axis_matches_jax(world4, name):
    """mamba2's mixers run whole on every rank of "model" (no collective,
    no "model" sum of their gradients), its vocab split there."""
    metrics, states, report = world4[name]
    _steps_close("mamba2-1.3b", (metrics, states))


def test_zero3_checkpoint_restores_at_1x1_and_in_jax(world4):
    """The checkpoint the (2, 2) zero3 ranks wrote after their last step
    (each tensor gathered over both of its splits to rank 0) is the
    logical state: restored at (1, 1) bit for bit, and by JAX."""
    ckpt = str(world4["tmp"] / "z3")
    restored = _restored_is(ckpt, 2, world4["smollm-2x2-z3"][1][-1])
    jm, _ = _jax("smollm-360m")
    abstract = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32)
        if a.dtype == jnp.bfloat16 else a,
        jax.eval_shape(lambda k: jinit_train_state(jm, k), KEY))
    jrestored = jckpt.restore_checkpoint(ckpt, 2, abstract)
    for a, b in zip(jax.tree.leaves(jrestored.params),
                    jax.tree.leaves(to_jax_tree(restored.params))):
        assert np.array_equal(np.asarray(a), b)


def test_zero3_resume_is_bitwise(world4):
    """One zero3 step at (4, 1), saved, restored on the same mesh and
    stepped again: the straight run's second step bit for bit."""
    straight = world4["smollm-4x1-z3"]
    resumed = world4["resume-b"]
    assert resumed[0][0] == straight[0][1]
    for field in ("params", "m", "v"):
        for n, t in resumed[1][0][field].items():
            assert np.array_equal(t, straight[1][1][field][n]), (field, n)


def test_run_with_zero3_trains_and_resumes(world4):
    """``launch.train.run(model_par=2, zero3=True, remat=True)`` on 4
    ranks: the rank's shards of both splits, a checkpoint resumed, the
    replayed step bit for bit, every rank reporting the same losses."""
    (name, step, losses, more, shapes), *others = world4["run"]
    assert name == "TrainState" and step == 3
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert more[0] == losses[2] and len(more) == 2
    assert all(o[2:4] == (losses, more) for o in others)
    cfg = SMOKES["smollm-360m"]
    assert shapes["embed"] == (cfg.vocab // 2, cfg.d_model // 2)
    assert shapes["seg0.0.0.mix.wq.w"] == (cfg.d_model // 2, 8 * cfg.hd)
    assert shapes["seg0.0.0.mix.wk.w"] == (cfg.d_model // 2,
                                          cfg.n_kv * cfg.hd)
    assert shapes["ln_f.g"] == (cfg.d_model,)


def test_zero3_resident_bytes_are_a_data_share(world4):
    """A rank's parameters and moments under zero3 at (2, 2): what has a
    zero3 split is half (data = 2) of what it holds without zero3; what
    stays whole (norms, the router, biases, a dim 2 does not divide) is
    the same."""
    z3 = world4["smollm-2x2-z3"][2]
    plain = world4["smollm-2x2"][2]
    assert plain["whole"] == plain["resident"]
    split = plain["resident"] - z3["whole"]
    assert split > 0.9 * plain["resident"]
    assert z3["resident"] == z3["whole"] + split // 2


def _dry_step_log(model_par, data, zero3):
    """The collectives rank 0 of a ``(data, model_par)`` dry mesh counts in
    one train step of smoke smollm-360m on the meta device (the batch and
    sizes of ``_sharded_ranks._train``)."""
    mesh = DryMesh((data, model_par))
    ctx = ShardCtx(mesh=mesh, zero3=zero3)
    model = build_model(SMOKES["smollm-360m"], device="meta",
                        dtype=torch.float32, ctx=ctx)
    model.requires_grad_(True)
    tp = dict(model.named_parameters())
    opt = AdamWConfig(lr=LR, warmup=1)
    step = make_train_step(model, opt)
    batch = {k: v.to("meta") for k, v in synthetic_batch(
        model.cfg, BATCH, SEQ, seed=0, step=0, device="cpu").items()}
    step(TrainState(tp, adamw_init(tp, opt), 0), shard_batch(batch, ctx))
    return mesh.log.as_dict()


@pytest.mark.parametrize("name,mp,data,z3", [("smollm-2x2-z3", 2, 2, True),
                                              ("smollm-2x2", 2, 2, False)])
def test_dry_mesh_counts_the_collectives_a_step_runs(world4, name, mp, data,
                                                     z3):
    """A dry (2, 2) mesh runs no collective: each records its kind, a call
    and its result's bytes; the same step on the meta device counts what
    the 4 gloo ranks ran, kind by kind."""
    real = world4[name][2]["log"]
    dry = _dry_step_log(mp, data, z3)
    assert dry == real
    assert real["reduce-scatter"]["count"] > 0 if z3 else \
        real["reduce-scatter"]["count"] == 0


def test_gradient_sums_take_the_mesh_axes():
    """``grad_sum_axes`` reads the mesh's own axis names: on ("pod",
    "data", "model") a replicated gradient is summed over "pod" too (the
    fixed order ("data", "model") dropped it), a zero3 one over neither
    data axis (its reduce-scatter summed it), a GQA ``wk`` over "model"
    still."""
    cfg = SMOKES["smollm-360m"]
    mesh = DryMesh((2, 2, 2), ("pod", "data", "model"))
    ctx = ShardCtx(mesh=mesh, batch_axes=("pod", "data"))
    assert grad_sum_axes("ln_f.g", (), cfg, ctx) == ("pod", "data")
    z3 = ShardCtx(mesh=mesh, batch_axes=("pod", "data"), zero3=True,
                  zero3_axes=("pod", "data"))
    model = build_model(cfg, device="meta", ctx=z3)
    splits = {n: (p.shard, p.z3) for n, p in model.named_parameters()}
    wk = "seg0.0.0.mix.wk.w"
    assert splits[wk][0] is None and splits[wk][1].axes == ("pod", "data")
    assert grad_sum_axes(wk, splits[wk], cfg, z3) == ("model",)
    assert grad_sum_axes("ln_f.g", splits["ln_f.g"], cfg, z3) == \
        ("pod", "data")
    wq = "seg0.0.0.mix.wq.w"
    assert grad_sum_axes(wq, splits[wq], cfg, z3) == ()


def test_zero3_builds_a_rank_of_each_family_on_a_dry_mesh():
    """Every config the port trains builds a zero3 rank at (2, 2) (the
    RG-LRU and encoder-decoder ones at (2, 1)), and ``normal_`` draws the
    same logical weights into two splits as into none."""
    for arch, cfg in SMOKES.items():
        mp = 1 if cfg.block_pattern or cfg.enc_layers else 2
        ctx = ShardCtx(mesh=DryMesh((2, mp)), zero3=True)
        model = build_model(cfg, device="meta", ctx=ctx)
        assert any(getattr(p, "z3", None) is not None
                   for p in model.parameters()), arch
    cfg = SMOKES["deepseek-moe-16b"]
    whole = build_model(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(3))
    state = dict(whole.named_parameters())
    for rank in range(4):
        ctx = ShardCtx(mesh=DryMesh((2, 2), rank=rank), zero3=True)
        part = build_model(cfg, device="cpu", dtype=torch.float32, ctx=ctx,
                           generator=torch.Generator().manual_seed(3))
        want = shard_state(state, model_splits(part))
        for n, p in part.named_parameters():
            assert torch.equal(p, want[n]), (rank, n)
