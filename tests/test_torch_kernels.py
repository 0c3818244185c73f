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
from _off_card import off_card
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.attn_split import (aligned, check_kv_map,
                                            merge_partials)
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


# ------------------------------------------------- GQA / MQA through a map
# query head -> stored KV head: identity, smollm-360m's padded 16 -> 5 map
# (15 heads in groups of 3, the padded 16th on the last), MQA 16 -> 1
KV_MAPS = {"identity": list(range(16)),
           "gqa16to5": [min(h // 3, 4) for h in range(16)],
           "mqa16to1": [0] * 16}


def _mapped_inputs(rng, name, dtype, q_shape, kv_shape):
    """q and the stored-head k/v as torch/JAX pairs, the map as int32, and
    k/v expanded to the query heads by numpy for the JAX oracle."""
    m = np.asarray(KV_MAPS[name], np.int32)
    Hk = int(m.max()) + 1
    q = rng.normal(size=q_shape).astype(np.float32)
    k, v = (rng.normal(size=kv_shape[:2] + (Hk,) + kv_shape[3:])
            .astype(np.float32) for _ in range(2))
    tq, jq = _pair(q, dtype)
    (tk, _), (tv, _) = _pair(k, dtype), _pair(v, dtype)
    (_, jk), (_, jv) = _pair(k[:, :, m], dtype), _pair(v[:, :, m], dtype)
    return tq, tk, tv, torch.from_numpy(m), jq, jk, jv


@pytest.mark.parametrize("kv", list(KV_MAPS))
@pytest.mark.parametrize("T,S,qoff,window", [(48, 48, 0, 0),
                                             (17, 80, 63, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_with_kv_map_matches_jax_ref(kv, T, S, qoff, window,
                                                 dtype):
    rng = np.random.default_rng(T + S + len(kv))
    tq, tk, tv, m, jq, jk, jv = _mapped_inputs(rng, kv, dtype, (2, T, 16, 32),
                                               (2, S, 16, 32))
    got = flash_attention(tq, tk, tv, causal=True, q_offset=qoff,
                          window=window, kv_map=m)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, q_offset=qoff,
                                    window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("kv", list(KV_MAPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_with_kv_map_matches_jax_ref(kv, dtype):
    rng = np.random.default_rng(len(kv))
    tq, tk, tv, m, jq, jk, jv = _mapped_inputs(rng, kv, dtype, (4, 16, 32),
                                               (4, 90, 16, 32))
    lengths = np.asarray([0, 1, 90, 66], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lengths), kv_map=m)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    # the JAX oracle averages V over a row with no visible key, where the
    # kernels (and the port's oracle) give 0: rows of length > 0 compared
    np.testing.assert_allclose(_f32(got)[1:], _f32(want)[1:],
                               atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.all(got[0] == 0)


def test_kv_map_clamps_to_the_stored_heads():
    """A map value past the stored heads reads the last one, as the JAX
    model's ``jnp.minimum(q_to_kv, n_store - 1)`` (a padded MHA model's
    decode cache keeps only the real heads)."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.normal(size=(2, 6, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 9, 4, 32))
                             .astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([9, 5])
    got = decode_attention(q, k, v, lengths,
                           kv_map=torch.arange(6, dtype=torch.int32))
    idx = torch.tensor([0, 1, 2, 3, 3, 3])
    want = tref.decode_attention_ref(q, k[:, :, idx], v[:, :, idx], lengths)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ------------------------------------------------------- split-KV partials
def _chunk_partial(q, k, v, mask):
    """One chunk's partial, as a kernel writes it: q [R,D], k/v [R,n,D],
    mask [R,n] -> (o normalised over the chunk's keys, base-2 lse; -inf
    where the chunk sees no key)."""
    s = torch.einsum("rd,rnd->rn", q, k) / np.sqrt(q.shape[-1])
    s = torch.where(mask, s, -torch.inf)
    lse = torch.logsumexp(s, -1)                             # natural
    w = torch.where(mask, torch.exp(s - lse[:, None]), 0.0)
    o = torch.einsum("rn,rnd->rd", w, v)
    return o, lse / np.log(2.0)


@pytest.mark.parametrize("chunk", [16, 32, 48])
def test_merge_partials_equals_attention_over_the_whole_range(chunk):
    """Decode over S = 100 keys cut into chunks, merged, equals decode over
    the whole range: lengths 0 (a row whose every chunk is empty), 37 (the
    later chunks see no key) and 100."""
    rng = np.random.default_rng(chunk)
    B, H, S, D = 3, 4, 100, 32
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
            for _ in range(2))
    lengths = torch.tensor([0, 37, 100])
    want = tref.decode_attention_ref(q, k, v, lengths).reshape(B * H, D)
    qr = q.reshape(B * H, D)
    kr, vr = (x.permute(0, 2, 1, 3).reshape(B * H, S, D) for x in (k, v))
    valid = (torch.arange(S)[None] < lengths[:, None]).repeat_interleave(H, 0)
    parts = [_chunk_partial(qr, kr[:, c:c + chunk], vr[:, c:c + chunk],
                            valid[:, c:c + chunk])
             for c in range(0, S, chunk)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    assert torch.isinf(lse[-1, H:2 * H]).all()     # chunk past length 37
    o = torch.where(torch.isinf(lse)[..., None], torch.nan, o)  # unwritten
    got = merge_partials(o, lse)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.all(got[:H] == 0)                 # length 0 gives 0


def test_merge_partials_of_a_windowed_suffix():
    """A causal, windowed suffix (rows at q_offset 40, window 32) over 72
    keys, merged from 24-key chunks, equals the prefill oracle."""
    rng = np.random.default_rng(15)
    T, S, H, D, qoff, window = 8, 72, 2, 32, 64, 32
    q = torch.from_numpy(rng.normal(size=(1, T, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, S, H, D)).astype(np.float32))
            for _ in range(2))
    want = tref.flash_attention_ref(q, k, v, causal=True, q_offset=qoff,
                                    window=window)[0].reshape(T * H, D)
    qp = torch.arange(T)[:, None] + qoff
    kp = torch.arange(S)[None]
    mask = ((qp >= kp) & (qp - kp < window)).repeat_interleave(H, 0)
    qr = q[0].reshape(T * H, D)
    kr, vr = (x[0].permute(1, 0, 2).repeat(T, 1, 1) for x in (k, v))
    parts = [_chunk_partial(qr, kr[:, c:c + 24], vr[:, c:c + 24],
                            mask[:, c:c + 24]) for c in range(0, S, 24)]
    lse = torch.stack([p[1] for p in parts])
    assert torch.isinf(lse[0]).all()               # keys 0-23: all outside
    got = merge_partials(torch.stack([p[0] for p in parts]), lse)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ------------------------------------------------ launch plans (host side)
@pytest.mark.parametrize("T,S,qoff,window,causal", [
    (32, 2080, 2048, 2048, True), (1, 2049, 2048, 2048, True),
    (512, 512, 0, 0, True), (70, 300, 230, 0, True), (5, 300, 0, 0, False),
    (64, 64, -5, 0, True), (130, 200, 70, 50, True)])
@pytest.mark.parametrize("bn", [32, 64])
def test_flash_split_plan_covers_every_visible_key(T, S, qoff, window,
                                                   causal, bn):
    """The chunks of each query tile cover every tile holding a visible
    (query, key) pair, and only tiles inside the kernel's range."""
    n_split, per = tflash.split_plan(1, 2, T, S, causal=causal,
                                     window=window, q_offset=qoff, bn=bn,
                                     sms=132, blocks_per_sm=2)
    assert n_split >= 1 and per >= 1
    for q0 in range(0, T, tflash.BLOCK_M):
        n = tflash.visible_tiles(q0, T, S, bn, causal=causal, window=window,
                                 q_offset=qoff)
        assert n <= n_split * per
        qp = np.arange(q0, min(q0 + tflash.BLOCK_M, T))[:, None] + qoff
        kp = np.arange(S)[None]
        vis = np.ones((len(qp), S), bool)
        if causal:
            vis &= qp >= kp
        if window:
            vis &= qp - kp < window
        seen = np.flatnonzero(vis.any(0)) // bn
        if len(seen):
            assert seen.max() - seen.min() + 1 <= n
        else:
            assert n == 0


@pytest.mark.parametrize("B,H,Hk,S,cap", [
    (8, 16, 1, 2048, 16), (8, 16, 5, 1024, 64), (8, 16, 16, 1024, 64),
    (8, 16, 5, 40, 64), (1, 64, 1, 4096, 16), (3, 16, 16, 1, 64)])
def test_decode_split_plan(B, H, Hk, S, cap):
    chunk, n_split, n_hb = tdecode.split_plan(B, H, Hk, S, cap=cap, sms=132)
    assert chunk % tdecode.TILE == 0 and chunk * n_split >= S
    assert (n_split - 1) * chunk < S                 # no chunk wholly past S
    assert n_hb * min(cap, H) >= H
    blocks = B * Hk * n_hb
    # about 4 blocks an SM, never more chunks than tiles
    assert blocks * n_split < 4 * 132 + blocks or n_split == 1
    assert n_split <= -(-S // tdecode.TILE)


def test_check_kv_map_and_alignment():
    check_kv_map("t", None, 4, 4, torch.device("cpu"))
    check_kv_map("t", torch.zeros(4, dtype=torch.int32), 4, 1,
                 torch.device("cpu"))
    for bad in (None, torch.zeros(3, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int64)):
        with pytest.raises(ValueError):
            check_kv_map("t", bad, 4, 2, torch.device("cpu"))
    x = torch.zeros(2, 8, 3, 32, dtype=torch.bfloat16)
    assert aligned(x) is x
    one = torch.zeros(2, 8, 1, 32, dtype=torch.bfloat16)
    wide = one.expand(2, 8, 3, 32)                  # head stride 0
    assert aligned(wide) is wide
    odd = torch.zeros(2, 8, 3, 33, dtype=torch.bfloat16)[..., 1:]
    got = aligned(odd)
    assert got.is_contiguous() and torch.equal(got, odd)


# ------------------------------------------------------------ CPU dispatch
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    flash_attention.launches = decode_attention.launches = 0
    q = torch.zeros(1, 4, 2, 32)
    ops.attention(q, q, q)
    ops.decode_attention(q[:, 0], q, q, torch.tensor([4]))
    assert flash_attention.launches == 0 and decode_attention.launches == 0
    # without a map the plain versions are the oracles of ref.py
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 2, 32))
                                .astype(np.float32)) for _ in range(3))
    assert torch.equal(flash_attention_plain(q, k, v),
                       tref.flash_attention_ref(q, k, v))
    lengths = torch.tensor([3])
    assert torch.equal(decode_attention_plain(q[:, 0], k, v, lengths),
                       tref.decode_attention_ref(q[:, 0], k, v, lengths))


def test_non_cpu_tensor_without_kernel_raises():
    """A tensor on neither the CPU nor the card (a fake XLA tensor) has no
    kernel and no plain version: both entry points raise. A meta tensor
    gets the kernels' output shapes instead (tests/test_torch_dryrun.py)."""
    q = off_card(torch.zeros(1, 4, 2, 32))
    with pytest.raises(ValueError, match="no kernel for xla"):
        ops.attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for xla"):
        ops.decode_attention(q[:, 0], q, q, off_card(torch.ones(1)))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
