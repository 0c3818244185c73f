"""The dense GQA transformer of a configuration file, plainly.

Pre-norm layers: RMSNorm, causal attention with RoPE (the half-split
rotation, base ``rope_theta``) over grouped KV heads (query head h reads
KV head ``h // (heads / kv_heads)``), residual, RMSNorm, the gated MLP
``(silu(x @ wg) * (x @ wi)) @ wd``, residual; then RMSNorm and the
unembedding. Every product is float32 with TF32 off (``exact``). With
``precision="fp8"`` each operand of each product is rounded to
float8_e4m3 with one scale a tensor first: the control, one precision
below the bf16 the configurations serve in.

It works layer by layer, casting one layer's leaves up at a time, so a
model whose float32 copy would not fit beside its activations still runs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

HEAD_CHUNK = 8          # query heads a score block holds


def exact() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3 under one scale (its largest magnitude
    to 448), back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ w`` with both operands rounded to float8 in the forward, and
    the incoming gradient and the saved operands in float8 for the
    backward's two products."""

    @staticmethod
    def forward(ctx, a, w):
        qa, qw = fp8_round(a), fp8_round(w)
        ctx.save_for_backward(qa, qw)
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = fp8_round(g)
        return ((qg @ qw.transpose(-1, -2)).sum_to_size(qa.shape),
                (qa.transpose(-1, -2) @ qg).sum_to_size(qw.shape))


def _mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, w)
    return a @ w


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, D]; pos [T]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs                      # [T, half]
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(q, k, v, pos: torch.Tensor, precision: str) -> torch.Tensor:
    """Causal attention of q [B, T, H, D] over k, v [B, T, Hkv, D] at the
    same positions, HEAD_CHUNK query heads a block."""
    B, T, H, D = q.shape
    rep = H // k.shape[2]
    mask = pos[None, :] <= pos[:, None]                     # [T, S]
    outs = []
    for h0 in range(0, H, HEAD_CHUNK):
        hs = range(h0, min(H, h0 + HEAD_CHUNK))
        kv = [h // rep for h in hs]
        qh = q[:, :, h0:h0 + len(hs)].transpose(1, 2)       # [B, h, T, D]
        kh = k[:, :, kv].transpose(1, 2)
        vh = v[:, :, kv].transpose(1, 2)
        s = _mm(qh, kh.transpose(-1, -2), precision) / math.sqrt(D)
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(_mm(torch.softmax(s, -1), vh, precision))
    return torch.cat(outs, 1).transpose(1, 2)               # [B, T, H, D]


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict[str, Any],
          pos: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """One layer on x [B, T, d] (float32); ``w`` holds the layer's leaves
    in float32 by their short names."""
    B, T, _ = x.shape
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = rmsnorm(x, w["ln1"], eps)
    q = rope(_mm(h, w["wq"], precision).view(B, T, H, hd), pos, theta)
    k = rope(_mm(h, w["wk"], precision).view(B, T, Hkv, hd), pos, theta)
    v = _mm(h, w["wv"], precision).view(B, T, Hkv, hd)
    o = attention(q, k, v, pos, precision).reshape(B, T, H * hd)
    x = x + _mm(o, w["wo"], precision)
    h = rmsnorm(x, w["ln2"], eps)
    a = F.silu(_mm(h, w["wg"], precision)) * _mm(h, w["wi"], precision)
    return x + _mm(a, w["wd"], precision)


LAYER_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wi", "wd")


def layer_leaves(leaves: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    return {n: leaves[f"layers.{i}.{n}"].float() for n in LAYER_LEAVES}


@torch.no_grad()
def logits_at(cfg: Dict[str, Any], leaves: Dict[str, torch.Tensor],
              tokens: torch.Tensor, at: Sequence[int],
              precision: str = "f32") -> torch.Tensor:
    """The float32 logits [len(at), vocab] that the model gives at the
    positions ``at`` of the sequence ``tokens`` [T] (each position's
    logits predict the next token)."""
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    x = F.embedding(tokens[None], leaves["embed"]).float()
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, layer_leaves(leaves, i), cfg, pos, precision)
    x = rmsnorm(x[0, list(at)], leaves["ln_f"].float(), cfg["norm_eps"])
    return _mm(x, leaves["unembed"].float(), precision)


def widest_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """How far below the reference's best logit the chosen token's logit
    lies, at the worst of the rows: ref [n, V], chosen [n]."""
    best = ref.max(-1).values
    got = ref.gather(-1, chosen.long()[:, None])[:, 0]
    return float((best - got).max())


# ---------------------------------------------------------------- training
def _xent(x: torch.Tensor, ln_f, unembed, labels, eps, precision):
    logits = _mm(rmsnorm(x, ln_f, eps), unembed, precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of a leaf that collects its own gradient."""
    return t.detach().to(torch.float32, copy=True).requires_grad_()


def gradients(cfg: Dict[str, Any], leaves: Dict[str, torch.Tensor],
              batch: torch.Tensor, precision: str = "f32"):
    """(loss, float32 gradient of every leaf) of the mean token
    cross-entropy of ``batch`` [B, T + 1] (inputs the first T ids, labels
    the last T). The forward keeps each layer's input only; the backward
    runs one layer at a time from it."""
    tokens, labels = batch[:, :-1], batch[:, 1:]
    pos = torch.arange(tokens.shape[1], device=batch.device)
    eps = cfg["norm_eps"]
    with torch.no_grad():
        x = F.embedding(tokens, leaves["embed"]).float()
        inputs: List[torch.Tensor] = []
        for i in range(cfg["num_hidden_layers"]):
            inputs.append(x)
            x = layer(x, layer_leaves(leaves, i), cfg, pos, precision)
    grads: Dict[str, torch.Tensor] = {}
    x = x.requires_grad_()
    head = {n: _leaf(leaves[n]) for n in ("ln_f", "unembed")}
    loss = _xent(x, head["ln_f"], head["unembed"], labels, eps, precision)
    loss.backward()
    for n, t in head.items():
        grads[n] = t.grad
    dx = x.grad
    for i in reversed(range(cfg["num_hidden_layers"])):
        xi = inputs[i].requires_grad_()
        w = {n: _leaf(leaves[f"layers.{i}.{n}"]) for n in LAYER_LEAVES}
        layer(xi, w, cfg, pos, precision).backward(dx)
        for n, t in w.items():
            grads[f"layers.{i}.{n}"] = t.grad
        dx = xi.grad
        inputs[i] = None
    ge = torch.zeros(leaves["embed"].shape, dtype=torch.float32,
                     device=batch.device)
    ge.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    grads["embed"] = ge
    return loss.item(), grads


@torch.no_grad()
def adamw(leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], step: int,
          recipe: Dict[str, Any], precision: str = "f32"):
    """One AdamW update in place, the recipe's way: the gradient clipped to
    a global norm first (the pre-clip norm returned), the learning rate
    ``lr * min(1, step / warmup)`` at 1-based ``step``, bias-corrected
    moments, weight decay added to the normalised update of every leaf but
    those the recipe names, the result rounded to each leaf's own type
    (float8 under ``precision="fp8"``). Returns (pre-clip norm, the norm
    of each leaf's gradient as given, before the clip)."""
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(recipe["clip_norm"] / (gnorm + 1e-9), max=1.0)
    lr = recipe["lr"] * min(1.0, step / max(recipe["warmup"], 1))
    b1, b2 = recipe["b1"], recipe["b2"]
    b1c = 1.0 - torch.tensor(b1) ** torch.tensor(float(step))
    b2c = 1.0 - torch.tensor(b2) ** torch.tensor(float(step))
    norms = {}
    for name, p in leaves.items():
        norms[name] = float(grads[name].norm())
        g = grads[name] * scale
        m[name].mul_(b1).add_((1 - b1) * g)
        v[name].mul_(b2).add_((1 - b2) * g * g)
        delta = (m[name] / b1c) / (torch.sqrt(v[name] / b2c)
                                   + recipe["eps"])
        if name not in recipe["no_decay"]:
            delta = delta + recipe["weight_decay"] * p.float()
        new = p.float() - lr * delta
        p.copy_(fp8_round(new) if precision == "fp8" else new)
    return float(gnorm), norms
