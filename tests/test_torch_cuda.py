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
