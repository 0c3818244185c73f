"""The port's training path held to the JAX package's on the CPU: AdamW
(the cases of tests/test_training.py, and one update against JAX's on the
same tree), ``Model.loss`` and every parameter's gradient against
``jax.value_and_grad(Model.loss)`` for the seven families, one train step
against JAX's, ``synthetic_batch`` byte for byte, checkpoints across the two
packages, a resumed run bit for bit, the launcher end to end (``run`` returns
(state, losses), as JAX's does), and the scan wrappers' refusal of a device
that has no kernel.

Same weights on both sides: the JAX ``Model.init`` pytree in float32,
loaded through ``from_jax_params``; gradients come back through
``to_jax_tree``. Tolerance 2e-5 of each leaf's largest value (and 2e-5
relative): float32 on both sides, summed in other orders (the port's
attention gradient is the flash backward's formula, JAX's the autodiff of
its oracle, which agree to ~1e-6)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _off_card import off_card
from repro.configs import SMOKES as JSMOKES
from repro.launch.train import synthetic_batch as jsynthetic_batch
from repro.models.lm import build_model as jbuild
from repro.training import checkpoint as jckpt
from repro.training.optim import AdamWConfig as JAdamWConfig
from repro.training.optim import adamw_init as jadamw_init
from repro.training.optim import adamw_update as jadamw_update
from repro.training.trainer import init_train_state as jinit_train_state
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.configs import SMOKES
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.launch.train import run as train_run
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.convert import jax_leaves, to_jax_tree
from repro_torch.training import (AdamWConfig, adamw_init, adamw_update,
                                  init_train_state, latest_step,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)
from repro_torch.training.optim import AdamWState
from repro_torch.training.trainer import TrainState

TOL = 2e-5
KEY = jax.random.PRNGKey(0)

#: (arch, config changes): the seven families; smollm also as full smollm's
#: 15 heads padded to 16 over 5 KV heads
FAMILIES = {
    "smollm": ("smollm-360m", {}),
    "smollm-15to16": ("smollm-360m", {"n_heads": 15, "n_kv": 5,
                                      "d_model": 120}),
    "deepseek-moe": ("deepseek-moe-16b", {}),
    "deepseek-v3": ("deepseek-v3-671b", {}),
    "seamless": ("seamless-m4t-medium", {}),
    "qwen2-vl": ("qwen2-vl-7b", {}),
    "mamba2": ("mamba2-1.3b", {}),
    "recurrentgemma": ("recurrentgemma-9b", {}),
}


def _models(family, dtype=jnp.float32):
    arch, changes = FAMILIES[family]
    jcfg = dataclasses.replace(JSMOKES[arch], **changes)
    tcfg = dataclasses.replace(SMOKES[arch], **changes)
    jm = dataclasses.replace(jbuild(jcfg), dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(KEY))
    tm = build_model(tcfg, device="cpu", dtype=torch.float32)
    from_jax_params(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm


def _f32(batch):
    """Both packages' batches with float leaves in float32."""
    if isinstance(next(iter(batch.values())), torch.Tensor):
        return {k: v.float() if v.is_floating_point() else v
                for k, v in batch.items()}
    return {k: v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v
            for k, v in batch.items()}


def _leaf_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _tree_close(got, want, tol=TOL):
    jax.tree.map(lambda g, w: _leaf_close(g, w, tol), got, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)


# ------------------------------------------------------------------- AdamW
def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup=1, weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update({"w": 2 * params["w"]}, state,
                                        params, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-2
    assert state.step == 200


def test_adamw_grad_clipping_reported():
    cfg = AdamWConfig(clip_norm=1.0)
    params = {"w": torch.ones(4)}
    _, _, gnorm = adamw_update({"w": torch.full((4,), 100.0)},
                               adamw_init(params, cfg), params, cfg)
    assert float(gnorm) == pytest.approx(200.0)


def test_adamw_update_matches_jax():
    """Three updates of a tree with 1-D and 2-D leaves, a bf16 leaf among
    them, warmup and clipping both active: parameters, moments and the
    reported norms as JAX's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4), "d": (6, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    jcfg = JAdamWConfig(lr=1e-2, warmup=4, clip_norm=2.0)
    tcfg = AdamWConfig(lr=1e-2, warmup=4, clip_norm=2.0)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "d" else jnp.float32)
          for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "d"
                                    else torch.float32)
          for k, v in p0.items()}
    jst, tst = jadamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * 3 for k, s in
             shapes.items()}
        jp, jst, jn = jadamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                    jst, jp, jcfg)
        tp, tst, tn = adamw_update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, tst, tp, tcfg)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert tst.step == int(jst.step) == 3
    for k in shapes:
        _leaf_close(tp[k].float().numpy(), np.asarray(jp[k], np.float32))
        _leaf_close(tst.m[k].numpy(), jst.m[k])
        _leaf_close(tst.v[k].numpy(), jst.v[k])
    assert tp["d"].dtype == torch.bfloat16


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_match_jax(family):
    jm, params, tm = _models(family)
    cfg = tm.cfg
    jb = _f32(jsynthetic_batch(jm.cfg, 2, 24, seed=0, step=3))
    tb = _f32(synthetic_batch(cfg, 2, 24, seed=0, step=3, device="cpu"))
    if cfg.mtp:
        assert "labels2" in tb
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
    tm.requires_grad_(True)
    loss = tm.loss(tb)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    # a leaf the loss does not read (the embedding of a model fed
    # embeddings) has no gradient here and a zero one in JAX
    unread = [n for n, g in grads.items() if g is None]
    assert unread == (["embed"] if family == "qwen2-vl" else [])
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in tm.named_parameters()}
    _tree_close(to_jax_tree(grads), jg)
    if family == "smollm-15to16":
        # the padded 16th query head's output rows of wo: zero weights, a
        # gradient that is not zero (its output is the mean of the visible
        # V), in both packages
        rows = slice(cfg.n_heads * cfg.hd, None)
        g = grads["seg0.0.0.mix.wo.w"][rows]
        assert float(g.abs().max()) > 0
        assert float(np.abs(np.asarray(jg["seg0"][0]["mix"]["wo"]["w"])[
            0, rows]).max()) > 0


def test_remat_keeps_the_loss_and_the_gradients():
    _, _, tm = _models("smollm")
    batch = synthetic_batch(tm.cfg, 2, 24, seed=1, step=0, device="cpu")
    tm.requires_grad_(True)
    out = []
    for remat in (False, True):
        tm.remat = remat
        for p in tm.parameters():
            p.grad = None
        loss = tm.loss(batch)
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone()
                                    for n, p in tm.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(out[0][1][n], out[1][1][n]) for n in out[0][1])


def test_one_train_step_matches_jax():
    """One step from the same weights and batch: the loss, the reported
    norm and every updated parameter and moment as JAX's (weight decay by
    the JAX leaf's rank: the stacked norm gains are decayed).

    Adam's first step moves an element by lr g/(|g| + eps) (g clipped,
    eps 1e-8): where |g| is within ~100 eps of 0 that ratio is
    ill-conditioned, and gradients that agree to 1e-10 move it by up to lr.
    Such elements are held to lr, the most the step can move them; every
    other element to the file's tolerance."""
    jm, params, tm = _models("smollm")
    jcfg, tcfg = (C(lr=1e-2, warmup=1) for C in (JAdamWConfig, AdamWConfig))
    jstate = jinit_train_state(jm, KEY, jcfg)._replace(params=params)
    jstate, jmet = jax.jit(jmake_train_step(jm, jcfg))(
        jstate, jsynthetic_batch(jm.cfg, 2, 24, seed=0, step=0))
    tm.requires_grad_(True)
    tp = dict(tm.named_parameters())
    tstate = TrainState(tp, adamw_init(tp, tcfg), 0)
    tstate, tmet = make_train_step(tm, tcfg)(
        tstate, synthetic_batch(tm.cfg, 2, 24, seed=0, step=0, device="cpu"))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    assert tstate.step == int(jstate.step) == 1
    ghat = jax.tree.map(lambda m: np.abs(np.asarray(m)) / (1 - jcfg.b1),
                        jstate.opt.m)

    def step_close(got, want, g):
        ill = g <= 1e-6
        assert np.abs(got - np.asarray(want))[ill].max(initial=0) <= \
            1.01 * jcfg.lr
        _leaf_close(np.where(ill, 0, got), np.where(ill, 0, want))
    jax.tree.map(step_close, to_jax_tree(tstate.params), jstate.params, ghat)
    _tree_close(to_jax_tree(tstate.opt.m), jstate.opt.m)
    _tree_close(to_jax_tree(tstate.opt.v), jstate.opt.v)


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_synthetic_batch_is_jax_byte_for_byte(arch):
    jb = jsynthetic_batch(JSMOKES[arch], 2, 40, seed=3, step=5)
    tb = synthetic_batch(SMOKES[arch], 2, 40, seed=3, step=5, device="cpu")
    assert sorted(jb) == sorted(tb)
    for k, j in jb.items():
        t = tb[k]
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.bfloat16:
            assert str(j.dtype) == "bfloat16"
            t, j = t.view(torch.int16).numpy(), np.asarray(j).view(np.int16)
        else:
            t, j = t.numpy(), np.asarray(j)
        assert t.dtype == j.dtype and np.array_equal(t, j), k


# -------------------------------------------------------------- checkpoints
def _bf16_states():
    """The bf16 smoke TrainState of both packages from the same weights."""
    jcfg = JSMOKES["smollm-360m"]
    jm = jbuild(jcfg)
    jstate = jinit_train_state(jm, KEY)
    tm = build_model(SMOKES["smollm-360m"], device="cpu")
    from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 jstate.params), tm)
    tm.requires_grad_(True)
    tp = dict(tm.named_parameters())
    return jm, jstate, tm, TrainState(tp, adamw_init(tp), 0)


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    jm, jstate, tm, tstate = _bf16_states()
    rng = np.random.default_rng(0)
    # moments and steps that are not zeros, so that each leaf is checked
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32), opt=jstate.opt._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                             jnp.float32), jstate.opt.m)))
    jckpt.save_checkpoint(str(tmp_path), 7, jstate)
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert len(manifest["paths"]) == 35
    assert manifest["paths"][0] == ".params/['embed']"
    assert manifest["paths"][-1] == ".step"
    blank = build_model(SMOKES["smollm-360m"], device="cpu")
    blank.requires_grad_(True)
    bp = dict(blank.named_parameters())
    restored = restore_checkpoint(str(tmp_path), 7,
                                  TrainState(bp, adamw_init(bp), 0))
    assert restored.step == restored.opt.step == 7
    for n, p in tm.named_parameters():
        assert restored.params[n].dtype == p.dtype   # bf16, norm gains f32
        assert torch.equal(restored.params[n], p), n
    _tree_close(to_jax_tree(restored.opt.m), jstate.opt.m, tol=0.0)


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    jm, jstate, tm, tstate = _bf16_states()
    g = torch.Generator().manual_seed(3)
    for t in tstate.opt.v.values():
        t.copy_(torch.rand(t.shape, generator=g))
    tstate = TrainState(tstate.params, AdamWState(4, tstate.opt.m,
                                                  tstate.opt.v), 4)
    save_checkpoint(str(tmp_path), 4, tstate)
    abstract = jax.eval_shape(lambda k: jinit_train_state(jm, k), KEY)
    restored = jckpt.restore_checkpoint(str(tmp_path), 4, abstract)
    assert int(restored.step) == int(restored.opt.step) == 4
    for (path, want), got in zip(jax_leaves(tstate.params, numpy=False),
                                 jax.tree.leaves(restored.params)):
        assert str(got.dtype) == str(want.dtype)[6:], path
        if want.dtype == torch.bfloat16:
            got, want = np.asarray(got).view(np.int16), want.view(torch.int16)
        assert np.array_equal(np.asarray(got), want.numpy()), path
    for (_, want), got in zip(jax_leaves(tstate.opt.v),
                              jax.tree.leaves(restored.opt.v)):
        assert np.array_equal(np.asarray(got), want)
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(jstate.params)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """4 steps with a checkpoint at 2; a state restored from it replays
    steps 2-3 to bit-identical parameters and moments."""
    cfg = SMOKES["smollm-360m"]
    opt = AdamWConfig(lr=1e-3)
    model = build_model(cfg, device="cpu")
    step_fn = make_train_step(model, opt)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    for step in range(4):
        state, _ = step_fn(state, synthetic_batch(cfg, 2, 16, seed=7,
                                                  step=step, device="cpu"))
        if step == 1:
            save_checkpoint(str(tmp_path), 2, state)
    assert latest_step(str(tmp_path)) == 2
    other = build_model(cfg, device="cpu")
    other.requires_grad_(True)
    op = dict(other.named_parameters())
    resumed = restore_checkpoint(str(tmp_path), 2,
                                 TrainState(op, adamw_init(op, opt), 0))
    assert resumed.step == 2
    other_fn = make_train_step(other, opt)
    for step in range(2, 4):
        resumed, _ = other_fn(resumed, synthetic_batch(cfg, 2, 16, seed=7,
                                                       step=step,
                                                       device="cpu"))
    for n in state.params:
        assert torch.equal(state.params[n], resumed.params[n]), n
        assert torch.equal(state.opt.m[n], resumed.opt.m[n]), n
        assert torch.equal(state.opt.v[n], resumed.opt.v[n]), n
    assert resumed.opt.step == state.opt.step == 4


def test_checkpoint_atomicity(tmp_path, monkeypatch):
    """A bogus directory never shadows the newest complete checkpoint, and
    a write that fails leaves no temp directory behind."""
    model = build_model(SMOKES["smollm-360m"], device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), 5, state)
    os.makedirs(tmp_path / "step_00000009")     # incomplete: no manifest
    assert latest_step(str(tmp_path)) == 5

    def disk_full(*a, **k):
        raise OSError("no space left on device")
    monkeypatch.setattr(np.lib.format, "write_array_header_1_0", disk_full)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 6, state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000009"]
    assert latest_step(str(tmp_path)) == 5


def test_launcher_end_to_end(tmp_path):
    """launch.train drives a (tiny) run with checkpoints on the CPU, then
    resumes from the newest one."""
    _, losses = train_run("smollm-360m", steps=6, batch=2, seq=16,
                          ckpt_dir=str(tmp_path), ckpt_every=3,
                          log_every=0, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert latest_step(str(tmp_path)) == 6
    _, more = train_run("smollm-360m", steps=8, batch=2, seq=16,
                        ckpt_dir=str(tmp_path), resume=True, log_every=0,
                        device="cpu")
    assert len(more) == 2                        # 6 -> 8
    # a model axis of 2 needs a process group (tests/
    # test_torch_sharded_train.py runs one): alone the run refuses it
    with pytest.raises(ValueError, match="process group"):
        train_run("smollm-360m", steps=1, model_par=2, device="cpu")


def test_train_loss_decreases():
    """20 steps over one repeated batch: the loss drops by more than 1.0."""
    cfg = SMOKES["smollm-360m"]
    opt = AdamWConfig(lr=1e-3, warmup=10)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    step_fn = make_train_step(model, opt)
    batch = synthetic_batch(cfg, 4, 32, seed=0, step=0, device="cpu")
    losses = []
    for _ in range(20):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses


# ------------------------------------------------------ scans on the card
def _meta(*shape):
    """A tensor that stands where a CUDA tensor would, on neither the CPU
    nor the card nor the meta device (whose tensors get the kernels'
    output shapes): ``_off_card.off_card``."""
    return off_card(torch.zeros(*shape))


def test_scans_have_no_kernel_off_the_card():
    """A tensor neither on the CPU nor on the card has no kernel: the scan
    wrappers raise before any launch, with or without a gradient (through
    their autograd Functions, whose forward calls the wrapper)."""
    for grad in (False, True):
        a = _meta(1, 8, 16).requires_grad_(grad)
        with pytest.raises(ValueError, match="no kernel"):
            rglru_scan(a, _meta(1, 8, 16))
        x = _meta(1, 8, 2, 4).requires_grad_(grad)
        with pytest.raises(ValueError, match="no kernel"):
            ssd_scan.ssd_chunked(x, _meta(1, 8, 16), _meta(1, 8, 16),
                                 _meta(1, 8, 2), _meta(2), _meta(2))
    with torch.no_grad():     # no gradient asked: the usual device check
        with pytest.raises(ValueError, match="no kernel"):
            rglru_scan(_meta(1, 8, 16).requires_grad_(), _meta(1, 8, 16))


def test_run_returns_state_and_losses():
    """``run`` returns exactly (state, losses), as the JAX launcher's
    ``state, losses = run(...)`` unpacks it: here on mamba2's smoke config,
    whose SSD gradient goes through ``SsdChunkedFn``."""
    state, losses = train_run("mamba2-1.3b", steps=2, batch=1, seq=24,
                              log_every=0, device="cpu")
    assert isinstance(state, TrainState) and state.step == 2
    assert len(losses) == 2 and np.isfinite(losses).all()
