"""The port's attention kernels: their plain PyTorch versions held against
the JAX oracles (``repro.kernels.ref``) and, for a few cases, against the
Pallas kernels in interpret mode. Inputs are made once with numpy and fed
to both packages. The Hopper kernels themselves are held against these plain
versions on the card in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_cost,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _pair(a, name):
    """The same numpy array as a torch and a JAX array of one dtype."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- flash attn
@pytest.mark.parametrize("B,T,S,H,D", [
    (2, 64, 64, 4, 64),
    (1, 200, 200, 3, 128),
    (2, 17, 300, 2, 64),      # ragged + chunked-prefill offset
    (1, 128, 128, 2, 96),     # non-128 head dim
    (1, 96, 96, 2, 32),       # smollm-smoke head dim
    (1, 257, 257, 1, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_ref_causal(B, T, S, H, D, dtype):
    rng = np.random.default_rng(B * 1000 + T + D)
    (tq, jq), (tk, jk), (tv, jv) = (
        _pair(rng.normal(size=shape).astype(np.float32), dtype)
        for shape in ((B, T, H, D), (B, S, H, D), (B, S, H, D)))
    qoff = S - T
    got = flash_attention(tq, tk, tv, causal=True, q_offset=qoff)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, q_offset=qoff)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("window", [16, 64])
def test_flash_plain_matches_jax_ref_window(window):
    rng = np.random.default_rng(window)
    (tq, jq), (tk, jk), (tv, jv) = (
        _pair(rng.normal(size=(1, 128, 2, 64)).astype(np.float32), "float32")
        for _ in range(3))
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


def test_flash_plain_matches_jax_ref_noncausal():
    rng = np.random.default_rng(5)
    tq, jq = _pair(rng.normal(size=(2, 64, 2, 64)).astype(np.float32),
                   "float32")
    (tk, jk), (tv, jv) = (
        _pair(rng.normal(size=(2, 80, 2, 64)).astype(np.float32), "float32")
        for _ in range(2))
    got = ops.attention(tq, tk, tv, causal=False)
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


@pytest.mark.parametrize("causal,qoff,window", [(True, 16, 0), (True, 0, 24),
                                                (False, 0, 0)])
def test_flash_plain_matches_pallas_interpret(causal, qoff, window):
    rng = np.random.default_rng(7)
    tq, jq = _pair(rng.normal(size=(1, 48, 2, 64)).astype(np.float32),
                   "float32")
    (tk, jk), (tv, jv) = (
        _pair(rng.normal(size=(1, 64, 2, 64)).astype(np.float32), "float32")
        for _ in range(2))
    got = flash_attention(tq, tk, tv, causal=causal, q_offset=qoff,
                          window=window)
    want = pallas_flash(jq, jk, jv, causal=causal, q_offset=qoff,
                        window=window, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


def test_flash_fully_masked_rows_give_zero():
    """A row that sees no key (a negative query offset puts it before every
    key) gives 0, as the kernels do."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 1, 32))
                                .astype(np.float32)) for _ in range(3))
    out = tref.flash_attention_ref(q, k, v, causal=True, q_offset=-2)
    assert torch.all(out[0, :2] == 0) and torch.all(out[0, 2:] != 0)


# -------------------------------------------------------------- decode attn
@pytest.mark.parametrize("B,S,H,D", [
    (2, 256, 4, 64), (3, 1000, 5, 128), (1, 128, 16, 64), (2, 513, 2, 96),
    (2, 200, 3, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_ref(B, S, H, D, dtype):
    rng = np.random.default_rng(B * 1000 + S + D)
    tq, jq = _pair(rng.normal(size=(B, H, D)).astype(np.float32), dtype)
    (tk, jk), (tv, jv) = (
        _pair(rng.normal(size=(B, S, H, D)).astype(np.float32), dtype)
        for _ in range(2))
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("pallas", [False, True])
def test_decode_plain_length_one(pallas):
    rng = np.random.default_rng(9)
    tq, jq = _pair(rng.normal(size=(2, 4, 64)).astype(np.float32), "float32")
    (tk, jk), (tv, jv) = (
        _pair(rng.normal(size=(2, 64, 4, 64)).astype(np.float32), "float32")
        for _ in range(2))
    lengths = np.asarray([1, 64], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    if pallas:
        want = pallas_decode(jq, jk, jv, jnp.asarray(lengths), interpret=True)
    else:
        want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


def test_decode_length_zero_gives_zero():
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.normal(size=(2, 2, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 8, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    out = decode_attention(q, k, v, torch.tensor([0, 3]))
    assert torch.all(out[0] == 0) and torch.all(out[1] != 0)


def test_decode_cost_counts_exact_keys():
    """This kernel's count: no head-dim padding, exactly ctx keys."""
    fl, by = decode_attention_cost(8, 16, 64, 300, dtype_bytes=2)
    assert fl == 8 * 4.0 * 16 * 64 * 300
    assert by == 8 * (2.0 * 300 * 16 * 64 * 2 + 2.0 * 16 * 64 * 2)


# ------------------------------------------------------------ CPU dispatch
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    flash_attention.launches = decode_attention.launches = 0
    q = torch.zeros(1, 4, 2, 32)
    ops.attention(q, q, q)
    ops.decode_attention(q[:, 0], q, q, torch.tensor([4]))
    assert flash_attention.launches == 0 and decode_attention.launches == 0
    assert flash_attention_plain is tref.flash_attention_ref
    assert decode_attention_plain is tref.decode_attention_ref


def test_non_cpu_tensor_without_kernel_raises():
    q = torch.empty(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError):
        ops.attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q, torch.empty(1, device="meta"))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
