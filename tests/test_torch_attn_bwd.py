"""The attention backward of the port held to the JAX package's on the
CPU: ``flash_attention_bwd_plain`` (the plain version of the Hopper
backward kernel) against autograd through the port's attention oracle,
against ``jax.grad`` through the JAX oracle ``ref.flash_attention_ref`` and
through ``flash_xla.flash_attention_xla`` (the custom VJP that JAX
differentiates off the TPU), for causal, windowed, causal-at-``q_offset``
and unmasked attention over the identity map, smollm's 16 -> 5, MQA 16 -> 1
and starcoder2's 32 -> 2 in groups of 12 and 20; the forward's row
log-sum-exp against ``flash_xla``'s; a fully masked row's zero gradients;
``FlashAttentionFn`` on CPU tensors.

float32 throughout, inputs from seeded numpy. Tolerance 2e-5 (absolute and
relative): the same float32 math summed in other orders."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_xla
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain)

TOL = 2e-5

MAPS = {
    "identity": (16, None),
    "gqa16to5": (16, [min(h // 3, 4) for h in range(16)]),
    "mqa16to1": (16, [0] * 16),
    "gqa32to2": (32, [min(h // 12, 1) for h in range(32)]),
}
#: (T, S, mask keywords): causal, a window, causal at a query offset (a
#: suffix over a prefix), no mask (an encoder or cross-attention)
MASKS = {
    "causal": (40, 40, dict(causal=True)),
    "window": (40, 40, dict(causal=True, window=9)),
    "q_offset": (24, 40, dict(causal=True, q_offset=16)),
    "unmasked": (24, 40, dict(causal=False)),
}
B, D = 2, 16


def _inputs(H, Hk, T, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hk, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v, dout


def _case(map_name, mask_name, seed=0):
    H, kv = MAPS[map_name]
    T, S, kw = MASKS[mask_name]
    Hk = max(kv) + 1 if kv else H
    arrs = _inputs(H, Hk, T, S, seed)
    kw = dict(dict(causal=True, window=0, q_offset=0), **kw)
    return arrs, kv, kw


def _torch_kw(kw, kv):
    return dict(kw, kv_map=None if kv is None else torch.tensor(
        kv, dtype=torch.int32))


def _plain(arrs, kv, kw):
    """(dq, dk, dv) of the plain backward, from the plain forward's output
    and lse."""
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    tkw = _torch_kw(kw, kv)
    out = flash_attention_plain(q, k, v, **tkw)
    lse = flash_attention_lse_plain(q, k, **tkw)
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, **tkw)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _jax_grad(fn_name, kv, causal, window, q_offset):
    """jit(grad) of sum(attention * dout) through the JAX function, with K/V
    expanded through the map (as the JAX model's attention does)."""
    def f(q, k, v, dout):
        if kv is not None:
            idx = jnp.asarray(kv)
            k, v = jnp.take(k, idx, axis=2), jnp.take(v, idx, axis=2)
        if fn_name == "ref":
            out = jref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
        else:   # blocks of 16 queries and keys: several blocks each way
            out = flash_xla.flash_attention_xla(
                q, k, v, 1.0 / np.sqrt(D), causal, window, q_offset, 16, 16)
        return jnp.sum(out * dout)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("map_name", sorted(MAPS))
def test_bwd_plain_matches_torch_autograd(map_name, mask_name):
    arrs, kv, kw = _case(map_name, mask_name, seed=1)
    q, k, v, dout = (torch.from_numpy(a).requires_grad_() for a in arrs)
    out = flash_attention_plain(q, k, v, **_torch_kw(kw, kv))
    want = torch.autograd.grad(out, (q, k, v), dout.detach())
    for g, w in zip(_plain(arrs, kv, kw), want):
        _close(g, w)


@pytest.mark.parametrize("fn_name", ["ref", "flash_xla"])
@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("map_name", sorted(MAPS))
def test_bwd_plain_matches_jax_grad(map_name, mask_name, fn_name):
    arrs, kv, kw = _case(map_name, mask_name, seed=2)
    grad = _jax_grad(fn_name, None if kv is None else tuple(kv),
                     kw["causal"], kw["window"], kw["q_offset"])
    want = grad(*(jnp.asarray(a) for a in arrs))
    for g, w in zip(_plain(arrs, kv, kw), want):
        _close(g, w)


@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_lse_plain_matches_flash_xla(mask_name):
    arrs, _, kw = _case("identity", mask_name, seed=3)
    q, k, v, _ = arrs
    _, want = flash_xla._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             1.0 / np.sqrt(D), kw["causal"], kw["window"],
                             kw["q_offset"], 16, 16)
    got = flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    **_torch_kw(kw, None))
    assert got.shape == (B, 16, q.shape[1]) and got.dtype == torch.float32
    _close(got, want)


def test_fully_masked_rows_give_zero_gradients():
    """A negative offset puts the first 5 query rows before every key:
    their lse is -inf, and they take no part in any gradient."""
    arrs, kv, kw = _case("gqa16to5", "causal", seed=4)
    kw = dict(kw, q_offset=-5)
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    tkw = _torch_kw(kw, kv)
    lse = flash_attention_lse_plain(q, k, **tkw)
    assert torch.isneginf(lse[:, :, :5]).all()
    assert torch.isfinite(lse[:, :, 5:]).all()
    dq, dk, dv = _plain(arrs, kv, kw)
    # (row 5 sees key 0 alone: its softmax has no gradient either)
    assert torch.all(dq[:, :5] == 0) and torch.all(dq[:, 6:].abs().sum(-1) > 0)
    # rows 0-4 reach nothing: the same dk/dv with their dout zeroed
    dout0 = dout.clone()
    dout0[:, :5] = 0
    out = flash_attention_plain(q, k, v, **tkw)
    _, dk0, dv0 = flash_attention_bwd_plain(q, k, v, out, lse, dout0, **tkw)
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    # and the autograd path agrees
    qg = q.clone().requires_grad_()
    got = torch.autograd.grad(flash_attention(qg, k, v, **tkw), qg, dout)[0]
    assert torch.all(got[:, :5] == 0)


@pytest.mark.parametrize("map_name", sorted(MAPS))
def test_flash_attention_fn_on_cpu_gives_the_plain_gradients(map_name):
    """With a gradient needed, ``flash_attention`` goes through
    ``FlashAttentionFn``: on CPU tensors its forward is the plain output and
    its backward the plain backward."""
    arrs, kv, kw = _case(map_name, "window", seed=5)
    q, k, v, dout = (torch.from_numpy(a).requires_grad_() for a in arrs)
    tkw = _torch_kw(kw, kv)
    out = ops.attention(q, k, v, kv_map_host=kv, **tkw)
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    assert torch.equal(out.detach(), flash_attention_plain(
        q.detach(), k.detach(), v.detach(), **tkw))
    got = torch.autograd.grad(out, (q, k, v), dout.detach())
    direct = FlashAttentionFn.apply(q, k, v, kw["causal"], kw["window"],
                                    kw["q_offset"], None, tkw["kv_map"], kv)
    again = torch.autograd.grad(direct, (q, k, v), dout.detach())
    want = _plain(arrs, kv, kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


def test_no_grad_needed_skips_the_autograd_function():
    arrs, kv, kw = _case("gqa16to5", "causal", seed=6)
    q, k, v, _ = (torch.from_numpy(a) for a in arrs)
    out = flash_attention(q, k, v, **_torch_kw(kw, kv))
    assert out.grad_fn is None and not out.requires_grad


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    arrs, kv, kw = _case("mqa16to1", "q_offset", seed=7)
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    tkw = _torch_kw(kw, kv)
    out = flash_attention_plain(q, k, v, **tkw)
    lse = flash_attention_lse_plain(q, k, **tkw)
    got = flash_attention_bwd(q, k, v, out, lse, dout, kv_map_host=kv, **tkw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **tkw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
