"""What each rank runs in the sharded tests (``tests/test_torch_sharded_*``),
started by ``repro_torch.launch.mesh.spawn`` over gloo on the CPU. A
module of its own, importing torch and the port only: the spawned ranks
import it, and never JAX. Rank 0 returns numpy results (the logical
tensors, gathered over the mesh); the other ranks return None."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import Mesh, make_mesh_for
from repro_torch.launch.shardings import (decode_cache, gather_cache,
                                          gather_state, grad_sum_axes,
                                          model_splits, shard_batch)
from repro_torch.models import blocks, build_model, from_jax_params
from repro_torch.models.sharding import ShardCtx, all_gather
from repro_torch.serving.paged_kv import (is_token_leaf_path,
                                          tree_map_with_path)
from repro_torch.training.trainer import sync_grads


def fake_mesh(data, model):
    """Enough of a mesh for a one-process test where no collective runs:
    every axis it uses has one rank, or the test ends before one."""
    import types
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 names=("data", "model"),
                                 coord=lambda axis: 0, backend="gloo")


def _ctx(model_par, ep_axes=("model",), kv_seq_shard=False, zero3=False,
         pods=1):
    """A ``(world / model_par, model_par)`` mesh, or with ``pods`` > 1 a
    ``(pods, world / pods / model_par, model_par)`` one over ("pod",
    "data", "model") whose batch (and zero3) axes are ("pod", "data")."""
    torch.set_num_threads(1)
    world = dist.get_world_size()
    if pods == 1:
        mesh, batch = make_mesh_for(world, model_par), ("data",)
    else:
        mesh = Mesh((pods, world // pods // model_par, model_par),
                    ("pod", "data", "model"))
        batch = ("pod", "data")
    return ShardCtx(mesh=mesh, batch_axes=batch, ep_axes=tuple(ep_axes),
                    kv_seq_shard=kv_seq_shard, zero3=zero3,
                    zero3_axes=batch)


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
    over "data" (dim 1), a split model's KV heads (self- and cross-
    attention's) over "model" (dim 3), an RG-LRU block's channels over
    "model" (its last dim)."""
    ctx = model.ctx

    def leaf(path, t):
        t = all_gather(t, ctx, ctx.batch_axes, 1) if split_rows else t
        if model.kv_split and path[-1] in ("k", "v", "xk", "xv"):
            t = all_gather(t, ctx, ctx.model_axis, 3)
        if model.segments[path[0]].kinds[path[1]][0] == "rec":
            t = all_gather(t, ctx, ctx.model_axis, t.dim() - 1)
        return t.numpy()
    return tree_map_with_path(leaf, caches)


def serve_and_grads(rank, dev, model_par, jobs, steps):
    """``_serve_and_grads`` of each (arch, JAX params, tokens[, labels2])
    of ``jobs`` on one mesh."""
    ctx = _ctx(model_par)
    out = [_serve_and_grads(ctx, arch, params, tokens, steps, *rest)
           for arch, params, tokens, *rest in jobs]
    return out if rank == 0 else None


def seq_decode(rank, dev, model_par, jobs, steps):
    """``_seq_decode`` of each (arch, JAX params, prompts, slots, dtype,
    KV dtype, config changes[, source embeddings]) of ``jobs`` on one mesh
    with ``kv_seq_shard``."""
    ctx = _ctx(model_par, kv_seq_shard=True)
    out = [_seq_decode(ctx, *job[:7], steps, *job[7:]) for job in jobs]
    return out if rank == 0 else None


def _seq_decode(ctx, arch, params, prompts, S, dtype, kv_dtype, changes,
                steps, srcs=None):
    """Each of the rank's rows of ``prompts`` (a list of token arrays of
    their own lengths, split over "data" where it divides them; with
    ``srcs`` each over its source embeddings [S_src, d]) prefilled alone
    and handed to decode (``decode_cache``: every real KV head, a window
    rolled into its ring, grown to ``S`` slots, the rank's slots), its
    token leaves stored as int8 codes with ``kv_dtype`` "int8", the rows
    joined into one decode cache; then ``steps`` greedy decode steps at each row's own
    position. Returns each call's logits, the greedy tokens and the
    logical cache after the last step (``gather_cache``), over every row,
    and the bytes a rank sent in the sequence-sharded exchanges a step."""
    model = _model(arch, params, ctx, getattr(torch, dtype), changes)
    B = len(prompts)
    split = ctx.split(0, ctx.batch_axes, B)
    mine = range(B)
    if split is not None:
        n = B // split.parts
        mine = range(split.index * n, (split.index + 1) * n)
    handed, firsts = [], []
    for b in mine:
        batch = {"tokens": torch.from_numpy(prompts[b])[None]}
        if srcs is not None:
            batch["src_embeds"] = torch.from_numpy(srcs[b])[None]
        lg, c = model.prefill(batch)
        firsts.append(lg)
        c = decode_cache(c, model, len(prompts[b]), S)
        if kv_dtype == "int8":
            c = tree_map_with_path(lambda p, t: blocks._kv_store(
                t, torch.int8) if is_token_leaf_path(p) else t, c)
        handed.append(c)
    caches = tree_map_with_path(lambda p, *ts: torch.cat(ts, 1), *handed)
    pos = torch.tensor([len(prompts[b]) for b in mine])
    logits = [torch.cat(firsts, 0)]
    tok = logits[0][:, 0].argmax(-1, keepdim=True)
    greedy = [tok]
    ctx.stats.zero()
    for s in range(steps):
        lg, caches = model.decode_step(caches, tok, pos + s)
        logits.append(lg)
        tok = lg[:, 0].argmax(-1, keepdim=True)
        greedy.append(tok)
    seq_bytes = ctx.stats.seq_bytes // max(1, steps)
    whole = gather_cache(caches, model)
    rows = split is not None
    mix = caches[0][-1]["mix"]
    return {"logits": [_rows(x, ctx, rows).float().numpy() for x in logits],
            "greedy": _rows(torch.cat(greedy, 1), ctx, rows).numpy(),
            "caches": tree_map_with_path(lambda p, t: (
                all_gather(t, ctx, ctx.batch_axes, 1) if rows else t
            ).float().numpy(), whole),
            "seq_bytes": seq_bytes,
            "local_slots": mix["c" if "c" in mix else "k"].shape[2]}


def _serve_and_grads(ctx, arch, params, tokens, steps, labels2=None,
                     src=None):
    """Prefill ``tokens`` [B, T] (the rank's rows; over the source
    embeddings ``src`` [B, S, d] where given), ``steps`` greedy decode
    steps over the prefill's caches handed to decode with ``steps`` more
    slots (``decode_cache``), then the loss and every gradient of
    ``tokens`` as its own labels (and ``labels2``, the MTP term's, where
    given). Returns the logical prefill logits, caches, greedy tokens,
    loss, gradients and the EP counters."""
    ctx.stats.zero()
    model = _model(arch, params, ctx)
    toks = torch.from_numpy(tokens)
    split = ctx.split(0, ctx.batch_axes, toks.shape[0]) is not None
    inputs = {"tokens": toks}
    if src is not None:
        inputs["src_embeds"] = torch.from_numpy(src)
    local = shard_batch(inputs, ctx)
    logits, caches = model.prefill(local)
    out = {"logits": _rows(logits, ctx, split).numpy(),
           "caches": logical_caches(caches, model, split)}
    T = local["tokens"].shape[1]
    caches = decode_cache(caches, model, T, T + steps)
    tok = logits[:, 0].argmax(-1, keepdim=True)
    greedy = [tok]
    for s in range(steps):
        logits, caches = model.decode_step(caches, tok, T + s)
        tok = logits[:, 0].argmax(-1, keepdim=True)
        greedy.append(tok)
    out["greedy"] = _rows(torch.cat(greedy, 1), ctx, split).numpy()
    model.requires_grad_(True)
    batch = {**inputs, "labels": toks}
    if labels2 is not None:
        batch["labels2"] = torch.from_numpy(labels2)
    batch = shard_batch(batch, ctx)
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
           restore=0, report=None):
    """``steps`` train steps (float32, AdamW with ``lr`` and warmup 1) of
    ``arch`` from the JAX ``params``, or from the checkpoint of step
    ``restore`` in ``ckpt_dir``, on the batches of the JAX launcher's
    stream (seed 0); the state saved into ``ckpt_dir`` after the last.
    Returns each step's (loss, grad norm) and the logical parameters and
    moments after it. A ``report`` dict gets the rank's resident bytes of
    parameters and moments (``resident``) and of those with no ZeRO-3
    split (``whole``), the collectives of the first step (``log``) and
    the (token, expert) pairs every rank dropped (``dropped``)."""
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
    if report is not None:
        def nbytes(z3):
            return sum(3 * p.numel() * p.element_size() for p in tp.values()
                       if (getattr(p, "z3", None) is not None) == z3)
        report.update(whole=nbytes(False), resident=nbytes(False)
                      + nbytes(True))
    metrics, states = [], []
    for s in range(state.step, state.step + steps):
        data = synthetic_batch(model.cfg, batch, seq, seed=0, step=s,
                               device="cpu")
        ctx.mesh.log.zero()
        state, met = step_fn(state, shard_batch(data, ctx))
        if report is not None and "log" not in report:
            report["log"] = ctx.mesh.log.as_dict()
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
        states.append({k: {n: t.numpy() for n, t in
                           gather_state(ts, shards, ctx).items()}
                       for k, ts in (("params", state.params),
                                     ("m", state.opt.m), ("v", state.opt.v))})
    if ckpt_dir:
        save_checkpoint(ckpt_dir, state.step, state, ctx)
    if report is not None:
        report["dropped"] = int(all_gather(
            torch.as_tensor(ctx.stats.dropped).reshape(1), ctx,
            ctx.mesh.names, 0).sum())
    return metrics, states


def train_steps(rank, dev, jobs):
    """``_train`` of each job (model_par, arch, JAX params, steps, batch,
    seq, lr, ckpt_dir, restore step) on its own mesh of the group."""
    out = [_train(_ctx(job[0]), *job[1:]) for job in jobs]
    return out if rank == 0 else None


def train_meshes(rank, dev, jobs):
    """``_train`` of each job (``_ctx`` keywords, arch, JAX params, steps,
    batch, seq, lr, ckpt_dir, restore step) on its own mesh of the group:
    (metrics, states, report)."""
    out = []
    for kw, *job in jobs:
        report = {}
        out.append((*_train(_ctx(**kw), *job, report=report), report))
    return out if rank == 0 else None


def launcher(rank, dev, ckpt_dir, zero3=False):
    """``launch.train.run`` with ``model_par=2`` in this process group
    (smoke smollm-360m, bf16; ZeRO-3 with remat with ``zero3``): 3 steps
    with a checkpoint at 2, then a resume from it to step 4."""
    from repro_torch.launch.train import run
    torch.set_num_threads(1)
    kw = dict(zero3=True, remat=True) if zero3 else {}
    state, losses = run("smollm-360m", steps=3, batch=2, seq=16,
                        ckpt_dir=ckpt_dir, ckpt_every=2, model_par=2,
                        log_every=0, device="cpu", **kw)
    _, more = run("smollm-360m", steps=4, batch=2, seq=16, ckpt_dir=ckpt_dir,
                  resume=True, model_par=2, log_every=0, device="cpu", **kw)
    return (type(state).__name__, state.step, losses, more,
            {n: tuple(p.shape) for n, p in state.params.items()})
