"""Training launcher (``repro.launch.train``'s counterpart): builds the
model, the data and the optimizer, and runs the train step with
checkpoint/restart, on the card unless ``--device cpu``.

Restart-safe: the data stream is stateless given (seed, step), so
``--resume`` continues from the newest checkpoint as the straight run
would. Checkpoints are in the JAX package's format, and either package
restores the other's. One device: a ``--model-par`` above 1 is the
multi-GPU slice and raises.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --full --steps 6 --batch 8 --seq 1024 --lr 1e-3 --warmup 10 \
        [--ckpt DIR --ckpt-every 3 --resume]
    # on a machine without a card: --device cpu (the smoke config by default)

``run`` returns (state, losses), as the JAX launcher's does; ``train_loop``
is its loop on a given config (a depth cut, say) and also returns the
run's train step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, SMOKES
from ..device import resolve_device
from ..models.lm import build_model
from ..training.checkpoint import (latest_step, restore_checkpoint,
                                   save_checkpoint)
from ..training.optim import AdamWConfig, adamw_init
from ..training.trainer import TrainState, init_train_state, make_train_step

__all__ = ["synthetic_batch", "run", "train_loop"]


def synthetic_batch(cfg, batch: int, seq: int, seed: int, step: int,
                    device=None):
    """Deterministic synthetic LM data, (seed, step) -> batch: the JAX
    launcher's numpy stream, as tensors on ``device`` (default: the card).
    ``tokens``/``labels`` int32 [batch, seq] (``inputs_embeds`` bf16 in
    place of tokens for a VLM), ``src_embeds`` bf16 for an encoder-decoder,
    ``labels2`` (the labels shifted once more) for a model with MTP."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1), dtype=np.int32)

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t if dtype is None else t.to(dtype)).to(dev)
    out = {"tokens": put(toks[:, :-1]), "labels": put(toks[:, 1:])}
    if cfg.family == "vlm":
        emb = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
        out = {"inputs_embeds": put(emb, torch.bfloat16),
               "labels": out["labels"]}
    if cfg.enc_layers:
        src = rng.normal(size=(batch, max(16, seq // 4), cfg.d_model))
        out["src_embeds"] = put(src, torch.bfloat16)
    if cfg.mtp:
        out["labels2"] = put(np.concatenate([toks[:, 2:], toks[:, -1:]], 1))
    return out


def run(arch: str, *, smoke: bool = True, steps: int = 100, batch: int = 8,
        seq: int = 128, lr: float = 3e-4, seed: int = 0, ckpt_dir: str = "",
        ckpt_every: int = 50, resume: bool = False, model_par: int = 1,
        log_every: int = 10, remat: bool = False, warmup: int = 100,
        device=None):
    """Train ``arch`` (its smoke config, or the full one with
    ``smoke=False``) in bf16 for steps ``[start, steps)``, ``start`` the
    newest checkpoint's step with ``resume`` and 0 otherwise, saving every
    ``ckpt_every`` steps into ``ckpt_dir``. Returns (state, losses)."""
    if model_par > 1:
        raise NotImplementedError(
            "model_par > 1 is the multi-GPU slice (ROADMAP queue 1 #8); "
            "the port trains on one device")
    state, losses, _ = train_loop(
        (SMOKES if smoke else ARCHS)[arch], steps=steps, batch=batch,
        seq=seq, lr=lr, seed=seed, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        resume=resume, log_every=log_every, remat=remat, warmup=warmup,
        device=device)
    return state, losses


def train_loop(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
               lr: float = 3e-4, seed: int = 0, ckpt_dir: str = "",
               ckpt_every: int = 50, resume: bool = False,
               log_every: int = 10, remat: bool = False, warmup: int = 100,
               device=None):
    """``run``'s loop on the config ``cfg`` itself. Returns (state, losses,
    step_fn), ``step_fn`` the run's train step (``make_train_step``)."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, remat=remat)
    opt_cfg = AdamWConfig(lr=lr, warmup=warmup)
    step_fn = make_train_step(model, opt_cfg)

    start = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        start = latest_step(ckpt_dir)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = restore_checkpoint(ckpt_dir, start, TrainState(
            params, adamw_init(params, opt_cfg), 0))
        print(f"resumed from step {start}")
    else:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed), opt_cfg)

    losses = []
    t0 = time.time()
    for step in range(start, steps):
        state, metrics = step_fn(state, synthetic_batch(cfg, batch, seq, seed,
                                                        step, device=dev))
        losses.append(float(metrics["loss"]))
        if log_every and (step + 1) % log_every == 0:
            dt = (time.time() - t0) / max(1, len(losses))
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f} ms/step", flush=True)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state)
    return state, losses, step_fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    _, losses = run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch,
                    seq=a.seq, lr=a.lr, seed=a.seed, ckpt_dir=a.ckpt,
                    ckpt_every=a.ckpt_every, resume=a.resume,
                    model_par=a.model_par, remat=a.remat, warmup=a.warmup,
                    device=a.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
