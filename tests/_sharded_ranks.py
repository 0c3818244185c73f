"""What each rank runs in the sharded tests (``tests/test_torch_sharded_*``),
started by ``repro_torch.launch.mesh.spawn`` over gloo on the CPU. A
module of its own, importing torch and the port only: the spawned ranks
import it, and never JAX. Rank 0 returns numpy results (the logical
tensors, gathered over the mesh); the other ranks return None."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.shardings import (gather_state, grad_sum_axes,
                                          model_splits, shard_batch)
from repro_torch.models import blocks, build_model, from_jax_params
from repro_torch.models.sharding import ShardCtx, all_gather
from repro_torch.training.trainer import sync_grads


def _ctx(model_par, ep_axes=("model",)):
    torch.set_num_threads(1)
    return ShardCtx(mesh=make_mesh_for(dist.get_world_size(), model_par),
                    ep_axes=tuple(ep_axes))


def _model(arch, params, ctx, dtype=torch.float32, changes=None):
    import dataclasses
    cfg = dataclasses.replace(SMOKES[arch], **(changes or {}))
    m = build_model(cfg, device="cpu", dtype=dtype, ctx=ctx)
    return from_jax_params(params, m)


def _rows(t, ctx, split):
    """A rank's per-row result gathered over the data axes (when the batch
    was split over them)."""
    return all_gather(t, ctx, ctx.batch_axes, 0) if split else t


def logical_caches(caches, model, split_rows):
    """The caches of every rank joined into the logical caches: batch rows
    over "data" (dim 1), a split model's KV heads over "model" (dim 3)."""
    ctx = model.ctx
    kv_split = model.kv_heads != model.cfg.n_kv

    def leaf(t):
        t = all_gather(t, ctx, ctx.batch_axes, 1) if split_rows else t
        if kv_split and t.dim() == 5:
            t = all_gather(t, ctx, ctx.model_axis, 3)
        return t.numpy()
    return [[{"mix": {k: leaf(v) for k, v in lay["mix"].items()}}
             for lay in seg] for seg in caches]


def serve_and_grads(rank, dev, model_par, jobs, steps):
    """``_serve_and_grads`` of each (arch, JAX params, tokens) of
    ``jobs`` on one mesh."""
    ctx = _ctx(model_par)
    out = [_serve_and_grads(ctx, arch, params, tokens, steps)
           for arch, params, tokens in jobs]
    return out if rank == 0 else None


def _serve_and_grads(ctx, arch, params, tokens, steps):
    """Prefill ``tokens`` [B, T] (the rank's rows), ``steps`` greedy decode
    steps over the prefill's caches grown by ``steps`` slots, then the loss
    and every gradient of ``tokens`` as its own labels. Returns the
    logical prefill logits, caches, greedy tokens, loss, gradients and the
    EP counters."""
    ctx.stats.zero()
    model = _model(arch, params, ctx)
    toks = torch.from_numpy(tokens)
    split = ctx.split(0, ctx.batch_axes, toks.shape[0]) is not None
    local = shard_batch({"tokens": toks}, ctx)["tokens"]
    logits, caches = model.prefill({"tokens": local})
    out = {"logits": _rows(logits, ctx, split).numpy(),
           "caches": logical_caches(caches, model, split)}
    T = local.shape[1]
    caches = [[{"mix": {k: torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, steps)) for k, v in lay["mix"].items()}}
        for lay in seg] for seg in caches]
    tok = logits[:, 0].argmax(-1, keepdim=True)
    greedy = [tok]
    for s in range(steps):
        logits, caches = model.decode_step(caches, tok, T + s)
        tok = logits[:, 0].argmax(-1, keepdim=True)
        greedy.append(tok)
    out["greedy"] = _rows(torch.cat(greedy, 1), ctx, split).numpy()
    model.requires_grad_(True)
    batch = shard_batch({"tokens": toks, "labels": toks}, ctx)
    loss = model.loss(batch)
    loss.backward()
    shards = model_splits(model)
    grads = sync_grads(
        {n: p.grad for n, p in model.named_parameters()},
        {n: grad_sum_axes(n, s, model.cfg, ctx) for n, s in shards.items()},
        ctx)
    out["loss"] = float(loss.detach())
    out["grads"] = {n: g.numpy() for n, g in
                    gather_state(grads, shards, ctx).items()}
    out["dropped"] = int(all_gather(torch.as_tensor(ctx.stats.dropped)
                                    .reshape(1), ctx, ("data", "model"),
                                    0).sum())
    out["branches"] = dict(ctx.stats.branches)
    return out


def ep_layer(rank, dev, model_par, ep_axes, layer, cfg, cases):
    """The port's EP layer on this rank: the MoE weights ``layer`` (numpy,
    logical; the rank keeps its experts) over each case (``x``, ``mode``):
    the rank's tokens of ``x`` [data, model, N, D] through the dispatch
    branch (``_moe_dispatch``, ``mode`` "dispatch"), or its rows of ``x``
    [data, B, T, D] through the replicated one (``_moe_replicated``,
    ``mode`` "decode" or "prefill"). Returns, a case, every rank's output,
    every rank's pairs dropped, the bytes this rank's ``all_to_all`` sent
    and the branch ``moe_apply`` takes for such an input."""
    ctx = _ctx(model_par, ep_axes)
    p = blocks.MoE(cfg, dtype=torch.float32, device="cpu")
    p.shared = None
    ep, i = ctx.ep_size, ctx.index(ctx.ep_axes)
    e_loc = cfg.n_experts // ep
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(layer["router"]))
        for n in ("w_in", "w_gate", "w_out"):
            w = torch.from_numpy(layer[n])[i * e_loc:(i + 1) * e_loc]
            setattr(p, n, torch.nn.Parameter(w.clone(), requires_grad=False))
    d, j = ctx.index("data"), ctx.index("model")
    out = []
    for x, mode in cases:
        ctx.stats.zero()
        if mode == "dispatch":
            y = blocks._moe_dispatch(p, torch.from_numpy(x[d, j])[None], cfg,
                                     ctx)[0]
            probe = torch.zeros(1, model_par, cfg.d_model)
        else:
            y = blocks._moe_replicated(p, torch.from_numpy(x[d]), cfg, ctx,
                                       mode)
            probe = torch.zeros(1, model_par + 1, cfg.d_model)
        ys = all_gather(y[None], ctx, ("data", "model"), 0).numpy()
        dropped = all_gather(torch.as_tensor(ctx.stats.dropped).reshape(1),
                             ctx, ("data", "model"), 0).numpy()
        sent = ctx.stats.a2a_bytes
        ctx.stats.zero()
        blocks.moe_apply(p, probe, cfg=cfg, mode="prefill", ctx=ctx)
        out.append((ys, dropped, sent, dict(ctx.stats.branches)))
    return out if rank == 0 else None


def _train(ctx, arch, params, steps, batch, seq, lr, ckpt_dir="",
           restore=0):
    """``steps`` train steps (float32, AdamW with ``lr`` and warmup 1) of
    ``arch`` from the JAX ``params``, or from the checkpoint of step
    ``restore`` in ``ckpt_dir``, on the batches of the JAX launcher's
    stream (seed 0); the state saved into ``ckpt_dir`` after the last.
    Returns each step's (loss, grad norm) and the logical parameters and
    moments after it."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint)
    from repro_torch.training.trainer import TrainState
    model = _model(arch, params, ctx)
    model.requires_grad_(True)
    tp = dict(model.named_parameters())
    opt = AdamWConfig(lr=lr, warmup=1)
    state = TrainState(tp, adamw_init(tp, opt), 0)
    if restore:
        state = restore_checkpoint(ckpt_dir, restore, state)
    step_fn = make_train_step(model, opt)
    shards = model_splits(model)
    metrics, states = [], []
    for s in range(state.step, state.step + steps):
        data = synthetic_batch(model.cfg, batch, seq, seed=0, step=s,
                               device="cpu")
        state, met = step_fn(state, shard_batch(data, ctx))
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
        states.append({k: {n: t.numpy() for n, t in
                           gather_state(ts, shards, ctx).items()}
                       for k, ts in (("params", state.params),
                                     ("m", state.opt.m), ("v", state.opt.v))})
    if ckpt_dir:
        save_checkpoint(ckpt_dir, state.step, state, ctx)
    return metrics, states


def train_steps(rank, dev, jobs):
    """``_train`` of each job (model_par, arch, JAX params, steps, batch,
    seq, lr, ckpt_dir, restore step) on its own mesh of the group."""
    out = [_train(_ctx(job[0]), *job[1:]) for job in jobs]
    return out if rank == 0 else None


def launcher(rank, dev, ckpt_dir):
    """``launch.train.run`` with ``model_par=2`` in this process group
    (smoke smollm-360m, bf16): 3 steps with a checkpoint at 2, then a
    resume from it to step 4."""
    from repro_torch.launch.train import run
    torch.set_num_threads(1)
    state, losses = run("smollm-360m", steps=3, batch=2, seq=16,
                        ckpt_dir=ckpt_dir, ckpt_every=2, model_par=2,
                        log_every=0, device="cpu")
    _, more = run("smollm-360m", steps=4, batch=2, seq=16, ckpt_dir=ckpt_dir,
                  resume=True, model_par=2, log_every=0, device="cpu")
    return (type(state).__name__, state.step, losses, more,
            {n: tuple(p.shape) for n, p in state.params.items()})
