"""The port's Hopper kernels held against their plain PyTorch versions on
the card, at the serving shapes. Marked ``cuda``; each test skips where no
CUDA card is present. Imports neither ``jax`` nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_chunked_plain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the Hopper kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,D,qoff,window,causal", [
    (512, 512, 64, 0, 0, True), (128, 640, 64, 512, 0, True),
    (200, 200, 32, 0, 0, True), (200, 200, 96, 0, 0, True),
    (200, 200, 128, 0, 0, True), (256, 256, 64, 0, 64, True),
    (100, 300, 64, 0, 0, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(T, S, D, qoff, window, causal,
                                            dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + S + D)
    tdt = DTYPES[dtype]
    q = torch.randn(1, T, 16, D, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(1, S, 16, D, generator=g, device=dev).to(tdt)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, q_offset=qoff,
                          window=window)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=qoff,
                                 window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,qoff", [(2112, 2112, 0), (32, 2080, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_head_dim_256_window_on_card(T, S, qoff, dtype):
    """recurrentgemma-9b's local attention: 16 query heads over one KV head
    (a stride-0 expand), head dim 256, window 2048; a full prefill past the
    window and a suffix over a cropped cache."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + S)
    tdt = DTYPES[dtype]
    q = torch.randn(1, T, 16, 256, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(1, S, 1, 256, generator=g, device=dev).to(tdt)
            .expand(-1, -1, 16, -1) for _ in range(2))
    kw = dict(causal=True, q_offset=qoff, window=2048)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_head_dim_256_on_card(dtype):
    """B=8 over a 2048-slot ring of one KV head expanded to 16 (stride 0)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(256)
    tdt = DTYPES[dtype]
    q = torch.randn(8, 16, 256, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(8, 2048, 1, 256, generator=g, device=dev).to(tdt)
            .expand(-1, -1, 16, -1) for _ in range(2))
    lengths = torch.tensor([1, 2048, 0, 17, 128, 129, 1024, 2024],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    assert torch.all(got[2] == 0)                    # length 0 gives 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_on_card(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    tdt = DTYPES[dtype]
    q = torch.randn(8, 16, 64, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(8, 1024, 16, 64, generator=g, device=dev).to(tdt)
            for _ in range(2))
    lengths = torch.tensor([1, 1024, 0, 17, 128, 129, 500, 1000],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def _ssd_inputs(dev, Bz, T, H=64, hd=64, N=128, with_init=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    x = rand(Bz, T, H, hd)
    B, C = rand(Bz, T, N, scale=0.5), rand(Bz, T, N, scale=0.5)
    dt = torch.rand(Bz, T, H, generator=g, device=dev) * 0.099 + 0.001
    A = -(torch.rand(H, generator=g, device=dev) * 1.5 + 0.5)
    D = rand(H)
    s0 = rand(Bz, H, hd, N) if with_init else None
    return x, B, C, dt, A, D, s0


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,T,with_init", [
    (1, 256, False), (1, 256, True), (1, 100, True), (1, 32, True),
    (8, 1, True)])
def test_ssd_kernel_matches_plain_on_card(Bz, T, with_init):
    """The serve shapes of mamba2-1.3b (H=64, hd=64, N=128): prefill, a
    ragged T, a suffix over a state, a decode step of 8 sequences."""
    dev = _card()
    args = _ssd_inputs(dev, Bz, T, with_init=with_init, seed=T)
    got = ssd_chunked(*args)
    want = ssd_chunked_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_kernel_state_chains_on_card():
    dev = _card()
    x, B, C, dt, A, D, _ = _ssd_inputs(dev, 1, 256, with_init=False, seed=1)
    y, s = ssd_chunked(x, B, C, dt, A, D)
    h = 128
    y1, s1 = ssd_chunked(x[:, :h], B[:, :h], C[:, :h], dt[:, :h], A, D)
    y2, s2 = ssd_chunked(x[:, h:], B[:, h:], C[:, h:], dt[:, h:], A, D, s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s2, s, atol=1e-4, rtol=1e-4)


def _rglru_inputs(dev, B, T, W, with_init, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(B, T, W, generator=g, device=dev) * 0.299 + 0.7
    x = torch.randn(B, T, W, generator=g, device=dev)
    s0 = torch.randn(B, W, generator=g, device=dev) if with_init else None
    return a, x, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W,with_init", [
    (1, 2112, 4096, False), (1, 32, 4096, True), (8, 1, 4096, True),
    (3, 33, 100, True), (1, 64, 4096, True), (2, 130, 100, True)])
def test_rglru_kernel_matches_plain_on_card(B, T, W, with_init):
    """recurrentgemma-9b's shapes (W = 4096): a prefill (two passes over
    64-step chunks), a suffix over a state, a decode step of 8 sequences;
    a ragged width; exactly one chunk; three chunks, the last ragged."""
    dev = _card()
    args = _rglru_inputs(dev, B, T, W, with_init, seed=T)
    got = rglru_scan(*args)
    want = rglru_scan_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rglru_kernel_state_chains_on_card():
    dev = _card()
    a, x, _ = _rglru_inputs(dev, 1, 2112, 4096, False, seed=1)
    h, s = rglru_scan(a, x)
    m = 1056
    h1, s1 = rglru_scan(a[:, :m], x[:, :m])
    h2, s2 = rglru_scan(a[:, m:], x[:, m:], s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([h1, h2], 1), h, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s2, s, atol=1e-4, rtol=1e-4)
