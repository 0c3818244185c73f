"""The port's Hopper kernels held against their plain PyTorch versions on
the card, at the serving shapes. Marked ``cuda``; each test skips where no
CUDA card is present. Imports neither ``jax`` nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
from repro_torch.kernels.ssd_scan import (STATE_DIMS, ssd_chunked,
                                          ssd_chunked_plain, ssd_plan)
from repro_torch.models.blocks import moe_apply, moe_init

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


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,qoff", [(256, 256, 0), (224, 256, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_moe_attention_shapes_on_card(T, S, qoff, dtype):
    """deepseek-moe-16b's attention: 16 query heads over 16 KV heads, head
    dim 128; a 256-token prompt and its suffix over a reused 32-token
    prefix."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + qoff)
    tdt = DTYPES[dtype]
    q = torch.randn(1, T, 16, 128, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(1, S, 16, 128, generator=g, device=dev).to(tdt)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=True, q_offset=qoff)
    want = flash_attention_plain(q, k, v, causal=True, q_offset=qoff)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_head_dim_128_mha_on_card(dtype):
    """deepseek-moe-16b's decode step: 8 slots of 1024 over 16 KV heads,
    head dim 128."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(128)
    tdt = DTYPES[dtype]
    q = torch.randn(8, 16, 128, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(8, 1024, 16, 128, generator=g, device=dev).to(tdt)
            for _ in range(2))
    lengths = torch.tensor([1, 1024, 0, 17, 128, 129, 512, 1000],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    assert torch.all(got[2] == 0)                    # length 0 gives 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape", [("prefill", (1, 256)),
                                        ("decode", (8, 1))])
def test_moe_layer_matches_cpu_on_card(mode, shape):
    """One full-width deepseek-moe-16b MoE layer (64 experts, top-6, 2
    shared) in float32 on the card against the same layer on the CPU: the
    sorted grouped path of a 256-token prefill and the token gather of an
    8-slot decode step. 1e-4: float32 on both sides (no TF32), only the
    order of summation over 2048 and 1408 terms differs."""
    dev = _card()
    cfg = ARCHS["deepseek-moe-16b"]
    cpu = moe_init(cfg, dtype=torch.float32, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    card = moe_init(cfg, dtype=torch.float32, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(*shape, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want = moe_apply(cpu, x, cfg=cfg, mode=mode)
    got = moe_apply(card, x.to(dev), cfg=cfg, mode=mode)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# smollm-360m's padded map: 15 heads in groups of 3 over 5 KV heads, the
# padded 16th on the last (min(h // 3, 4)); MQA sends all 16 to one head
MAPS = {"gqa16to5": (5, [min(h // 3, 4) for h in range(16)]),
        "mqa16to1": (1, [0] * 16)}


def _kv(dev, g, B, S, Hk, D, tdt):
    return (torch.randn(B, S, Hk, D, generator=g, device=dev).to(tdt)
            for _ in range(2))


def _map(dev, name):
    Hk, m = MAPS[name]
    return Hk, torch.tensor(m, dtype=torch.int32, device=dev)


def _flash_check(dev, dtype, T, S, D, *, kv="gqa16to5", B=1, seed=0, **kw):
    g = torch.Generator(device=dev).manual_seed(seed)
    tdt = DTYPES[dtype]
    Hk, kv_map = _map(dev, kv)
    q = torch.randn(B, T, 16, D, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, B, S, Hk, D, tdt)
    got = flash_attention(q, k, v, kv_map=kv_map, **kw)
    want = flash_attention_plain(q, k, v, kv_map=kv_map, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kv,T,S,D,window", [
    ("gqa16to5", 512, 512, 64, 0), ("mqa16to1", 512, 512, 64, 0),
    ("mqa16to1", 300, 300, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_kv_map_on_card(kv, T, S, D, window, dtype):
    """K/V hold the stored heads only and the kernel reads them through
    the map: smollm's non-uniform 16 -> 5 map, MQA from one head."""
    _flash_check(_card(), dtype, T, S, D, kv=kv, seed=T + D, causal=True,
                 window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 17, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_split_kv_suffix_on_card(T, dtype):
    """A short suffix over recurrentgemma's cropped window cache: 16 heads
    over one KV head, D = 256, q_offset 2048, window 2048; the bfloat16
    kernel splits each query tile's keys into chunks and merges them."""
    _flash_check(_card(), dtype, T, 2048 + T, 256, kv="mqa16to1", seed=T,
                 causal=True, q_offset=2048, window=2048)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("T,S,qoff,causal", [
    (100, 100, 0, True), (37, 133, 96, True), (70, 45, 0, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_ragged_tiles_on_card(D, T, S, qoff, causal, dtype):
    """T and S not multiples of 64, at every head dim: the ragged query
    rows are not written, the ragged keys are masked."""
    _flash_check(_card(), dtype, T, S, D, seed=D + T, causal=causal,
                 q_offset=qoff)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_fully_masked_rows_give_zero_on_card(dtype):
    """A negative offset puts the first rows before every key: they see
    no key and give 0."""
    got = _flash_check(_card(), dtype, 70, 70, 64, seed=3, causal=True,
                       q_offset=-5)
    assert torch.all(got[0, :5] == 0) and torch.all(got[0, 5:].abs().sum(-1)
                                                     > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv,S,D", [
    ("gqa16to5", 1024, 64), ("gqa16to5", 2048, 64), ("mqa16to1", 1024, 256),
    ("mqa16to1", 2048, 256), ("gqa16to5", 40, 64), ("mqa16to1", 40, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_kv_map_on_card(kv, S, D, dtype):
    """B = 8 sequences over the stored heads through the map, lengths 0, 1,
    S and ragged ones; S = 40 is shorter than one chunk."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S + D)
    tdt = DTYPES[dtype]
    Hk, kv_map = _map(dev, kv)
    q = torch.randn(8, 16, D, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, 8, S, Hk, D, tdt)
    lengths = torch.tensor([0, 1, S, S - 24, 17, 65, S // 2, S - 1],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths, kv_map=kv_map)
    want = decode_attention_plain(q, k, v, lengths, kv_map=kv_map)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    assert torch.all(got[0] == 0)                    # length 0 gives 0


# the rest of the dense family at full width: starcoder2-3b's 24 heads
# padded to 32 over 2 KV heads (min(h // 12, 1): groups of 12 and 20, the
# second with the 8 padded no-op heads) and qwen1.5-32b's 40 MHA heads
# padded to 48, over the 48 stored heads of a prefill or the 40 real ones
# of an ``init_cache`` cache (the kernel clamps heads 40-47 to 39)
DENSE_MAPS = {"starcoder2": (2, [min(h // 12, 1) for h in range(32)]),
              "qwen48": (48, list(range(48))),
              "qwen40": (40, list(range(48)))}


def _dense_kv(dev, g, B, S, Hk, D, kv_dtype, tdt):
    """K/V in q's dtype, or int8 codes over the whole range and the scale of
    the model's int8 cache."""
    if kv_dtype == "int8":
        return tuple(torch.randint(-127, 128, (B, S, Hk, D), generator=g,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2)) + (1 / 32,)
    return tuple(_kv(dev, g, B, S, Hk, D, tdt)) + (None,)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["starcoder2", "qwen40"])
@pytest.mark.parametrize("S", [40, 1000, 1024])
@pytest.mark.parametrize("kv_dtype", ["int8", "same"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_dense_maps_on_card(kv, S, kv_dtype, dtype):
    """B = 8 at head dim 128 through the dense family's maps, K/V in q's
    dtype or int8 codes (read by the kernel, dequantised by the plain
    version); S = 1000 is not a multiple of the 64-key tile, S = 40 is
    shorter than one; lengths 0, 1, S and ragged ones."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S + len(kv))
    tdt = DTYPES[dtype]
    Hk, m = DENSE_MAPS[kv]
    kv_map = torch.tensor(m, dtype=torch.int32, device=dev)
    q = torch.randn(8, len(m), 128, generator=g, device=dev).to(tdt)
    k, v, kv_scale = _dense_kv(dev, g, 8, S, Hk, 128, kv_dtype, tdt)
    lengths = torch.tensor([0, 1, S, S - 24, 17, 65, S // 2, S - 1],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths, kv_map=kv_map,
                           kv_scale=kv_scale)
    want = decode_attention_plain(q, k, v, lengths, kv_map=kv_map,
                                  kv_scale=kv_scale)
    torch.cuda.synchronize()
    assert got.dtype == tdt
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    assert torch.all(got[0] == 0)                    # length 0 gives 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 8])
def test_decode_kernel_int8_at_32k_on_card(B):
    """qwen1.5-32b's decode at 32768 slots, float32 q over int8 codes of
    N(0, 1) values (outputs ~0.01 over the long rows, so float32's 2e-5 is
    what holds them): the split plan cuts S into 2 chunks of 16384 at B = 8
    and 7 of 4736 at B = 2; lengths full, 1, off the tile and either side
    of a chunk's end."""
    dev = _card()
    S = 32768
    g = torch.Generator(device=dev).manual_seed(B)
    Hk, m = DENSE_MAPS["qwen40"]
    kv_map = torch.tensor(m, dtype=torch.int32, device=dev)
    q = torch.randn(B, len(m), 128, generator=g, device=dev)
    k, v = (torch.clamp(torch.round(torch.randn(
        B, S, Hk, 128, generator=g, device=dev) * 32), -127, 127).to(
            torch.int8) for _ in range(2))
    lengths = torch.tensor([S, 20037, 1, S - 24, 16385, 16383, 4681, S // 2]
                           if B == 8 else [4737, 9471], dtype=torch.int32,
                           device=dev)
    got = decode_attention(q, k, v, lengths, kv_map=kv_map, kv_scale=1 / 32)
    want = decode_attention_plain(q, k, v, lengths, kv_map=kv_map,
                                  kv_scale=1 / 32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=_tol("float32"),
                               rtol=_tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_int8_every_head_dim_on_card(D, dtype):
    """int8 K/V at every other head dim (rows of D bytes, 16-byte copies)
    through smollm's 16 -> 5 map."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(D)
    tdt = DTYPES[dtype]
    Hk, kv_map = _map(dev, "gqa16to5")
    q = torch.randn(8, 16, D, generator=g, device=dev).to(tdt)
    k, v, kv_scale = _dense_kv(dev, g, 8, 333, Hk, D, "int8", tdt)
    lengths = torch.tensor([0, 1, 333, 300, 17, 65, 64, 128],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths, kv_map=kv_map,
                           kv_scale=kv_scale)
    want = decode_attention_plain(q, k, v, lengths, kv_map=kv_map,
                                  kv_scale=kv_scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kv,T,S,qoff", [
    ("starcoder2", 512, 512, 0), ("starcoder2", 64, 544, 480),
    ("qwen48", 300, 300, 0), ("qwen48", 32, 288, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_dense_maps_on_card(kv, T, S, qoff, dtype):
    """Prefill and a suffix at head dim 128 through starcoder2's 32 -> 2
    map and qwen's padded MHA (48 heads over the prefill's 48)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + S)
    tdt = DTYPES[dtype]
    Hk, m = DENSE_MAPS[kv]
    kv_map = torch.tensor(m, dtype=torch.int32, device=dev)
    q = torch.randn(1, T, len(m), 128, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, 1, S, Hk, 128, tdt)
    kw = dict(causal=True, q_offset=qoff, kv_map=kv_map)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
def test_decode_kernel_refuses_int8_without_its_scale_on_card():
    """No quiet reading of codes as values, and no int8 path for a mix."""
    dev = _card()
    q = torch.zeros(2, 16, 128, device=dev, dtype=torch.bfloat16)
    k8 = torch.zeros(2, 64, 16, 128, device=dev, dtype=torch.int8)
    kb = k8.to(torch.bfloat16)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    for k, v, scale in ((k8, k8, None), (kb, kb, 1 / 32), (k8, kb, 1 / 32),
                        (k8.float(), k8.float(), None)):
        with pytest.raises(ValueError):
            decode_attention(q, k, v, lengths, kv_scale=scale)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take_on_card():
    """No fallback: a map of the wrong length, dtype or device, a head dim
    outside HEAD_DIMS or a dtype other than bf16/f32 raises."""
    dev = _card()
    q = torch.zeros(1, 8, 16, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 5, 64, device=dev, dtype=torch.bfloat16)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    good = torch.zeros(16, dtype=torch.int32, device=dev)
    for bad in (None, good[:15], good.long(), good.cpu()):
        with pytest.raises(ValueError):
            flash_attention(q, k, k, kv_map=bad)
        with pytest.raises(ValueError):
            decode_attention(q[:, 0], k, k, lengths, kv_map=bad)
    q48 = torch.zeros(1, 8, 16, 48, device=dev, dtype=torch.bfloat16)
    k48 = torch.zeros(1, 8, 5, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q48, k48, k48, kv_map=good)
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), k.half(), kv_map=good)


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
@pytest.mark.parametrize("N", STATE_DIMS)
@pytest.mark.parametrize("Bz", [1, 2, 8])
@pytest.mark.parametrize("T", [1, 16, 17, 32, 33, 100, 256, 288, 2048])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_kernel_both_paths_at_the_threshold_on_card(N, Bz, T, with_init):
    """Either side of the recurrence / dual-form threshold, a ragged last
    chunk and a long T, every state size, batched: the path ``ssd_plan``
    picks by T."""
    dev = _card()
    args = _ssd_inputs(dev, Bz, T, H=4, hd=64, N=N, with_init=with_init,
                       seed=T + N)
    got = ssd_chunked(*args)
    want = ssd_chunked_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _forced(path, args):
    """``ssd_chunked`` on the kernel of ``path`` whatever T is (the
    arguments are contiguous and aligned, as the wrapper would pass them)."""
    x, B, C, dt, A, D, s0 = args
    Bz, T, H, hd = x.shape
    y = torch.empty_like(x)
    sf = torch.empty((Bz, H, hd, B.shape[-1]), device=x.device)
    plan = ssd_plan(Bz, T, H, hd, B.shape[-1], path=path)
    return y, ssd_scan._launch(plan, x, B, C, dt, A, D, s0, y, sf)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dual", "recurrence"])
@pytest.mark.parametrize("T,hd", [(1, 64), (16, 64), (17, 48), (32, 128),
                                  (33, 64), (100, 64)])
def test_ssd_both_kernels_at_every_short_T_on_card(path, T, hd):
    """Each kernel is right on its own at the T where the threshold could
    sit, with a ragged head dim (a partial tile of state rows)."""
    dev = _card()
    args = _ssd_inputs(dev, 2, T, H=3, hd=hd, N=128, seed=T)
    got = _forced(path, args)
    want = ssd_chunked_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 100])
def test_ssd_kernel_takes_unaligned_views_on_card(T):
    """x, B and C as views that start off 16 bytes, as slices of a wider
    row: B and C get aligned copies, x is staged by plain copies."""
    dev = _card()
    x, B, C, dt, A, D, s0 = _ssd_inputs(dev, 2, T, H=3, hd=64, seed=5)
    wide = torch.zeros(2, T, 1 + 3 * 64 + 2 * 128, device=dev)
    wide[..., 1:1 + 3 * 64] = x.reshape(2, T, 3 * 64)
    wide[..., 1 + 3 * 64:1 + 3 * 64 + 128] = B
    wide[..., 1 + 3 * 64 + 128:] = C
    xv = wide[..., 1:1 + 3 * 64].unflatten(-1, (3, 64))
    Bv = wide[..., 1 + 3 * 64:1 + 3 * 64 + 128]
    Cv = wide[..., 1 + 3 * 64 + 128:]
    got = ssd_chunked(xv, Bv, Cv, dt, A, D, s0)
    want = ssd_chunked_plain(x, B, C, dt, A, D, s0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,T", [(8, 1), (1, 100)])
def test_ssd_in_place_state_equals_out_of_place_on_card(Bz, T):
    """``out_state`` aliasing ``init_state`` (decode's in-place update) gives
    what a separate output gives, on both paths."""
    dev = _card()
    args = _ssd_inputs(dev, Bz, T, seed=3)
    y, s = ssd_chunked(*args)
    cache = args[6].clone()
    y2, s2 = ssd_chunked(*args[:6], cache, out_state=cache)
    torch.cuda.synchronize()
    assert s2 is cache
    assert torch.equal(y2, y) and torch.equal(s2, s)


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
    (3, 33, 100, True), (1, 64, 4096, True), (2, 130, 100, True),
    (2, 130, 99, True)])
def test_rglru_kernel_matches_plain_on_card(B, T, W, with_init):
    """recurrentgemma-9b's shapes (W = 4096): a prefill (two passes over
    64-step chunks), a suffix over a state, a decode step of 8 sequences;
    a ragged width; exactly one chunk; three chunks, the last ragged, also
    with a width of rows that are not on 16 bytes (4-byte copies)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 32, 64, 65, 2112, 4103])
def test_rglru_one_pass_repeats_and_replays_on_card(T):
    """One pass with a look-back over flags: three calls in a row, then
    three replays of one CUDA graph of the call (its memset clears the
    flags each time; the outputs are poisoned before each replay), each
    equal to the plain version. B = 3 and a ragged W."""
    dev = _card()
    args = _rglru_inputs(dev, 3, T, 1000, True, seed=T)
    want = rglru_scan_plain(*args)
    for _ in range(3):
        got = rglru_scan(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru_scan(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rglru_scan(*args)
    for _ in range(3):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# the last three families: qwen2-vl-7b's 28 heads padded to 32 over 4 KV
# heads (min(h // 7, 3): the last KV head serves 11, 4 of them padded);
# seamless-m4t-medium's 16 MHA heads of 64 attending to encoder frames
# without a mask (its encoder, and the cross-attention of a prefill and of
# a decode step)
VLM_MAP = [min(h // 7, 3) for h in range(32)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,qoff", [(512, 512, 0), (48, 560, 512),
                                      (256, 256, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_qwen2_vl_map_on_card(T, S, qoff, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + S)
    tdt = DTYPES[dtype]
    kv_map = torch.tensor(VLM_MAP, dtype=torch.int32, device=dev)
    q = torch.randn(1, T, 32, 128, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, 1, S, 4, 128, tdt)
    kw = dict(causal=True, q_offset=qoff, kv_map=kv_map)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [40, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_qwen2_vl_map_on_card(S, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S)
    tdt = DTYPES[dtype]
    kv_map = torch.tensor(VLM_MAP, dtype=torch.int32, device=dev)
    q = torch.randn(8, 32, 128, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, 8, S, 4, 128, tdt)
    lengths = torch.tensor([1, S, S - 24, 17, 65, S // 2, S - 1, 3],
                           dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths, kv_map=kv_map)
    want = decode_attention_plain(q, k, v, lengths, kv_map=kv_map)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(64, 64), (256, 64), (1, 64), (300, 17),
                                 (13, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_without_mask_over_encoder_frames_on_card(T, S, dtype):
    """The encoder (T = S) and the cross-attention of a prefill (T queries
    over S frames), no mask, head dim 64, 16 over 16 heads."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T * 3 + S)
    tdt = DTYPES[dtype]
    q = torch.randn(1, T, 16, 64, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, 1, S, 16, 64, tdt)
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_cross_attention_every_length_at_s_on_card(S, dtype):
    """The cross-attention of a decode step: 8 sequences, one query each,
    over all S encoder frames (every length at S)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S)
    tdt = DTYPES[dtype]
    q = torch.randn(8, 16, 64, generator=g, device=dev).to(tdt)
    k, v = _kv(dev, g, 8, S, 16, 64, tdt)
    lengths = torch.full((8,), S, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen2-vl-7b",
                                  "seamless-m4t-medium"])
def test_smoke_model_matches_cpu_on_card(arch):
    """The smoke model in float32 on the card (kernels) and on the CPU
    (plain versions), the same weights: a prefill (from input embeddings for
    qwen2-vl, with 8 source frames for seamless), then 3 decode steps into
    the caches as ``DecodeBatch.add`` admits them. 1e-4 of the largest
    logit: float32 on both sides, only the order of summation differs."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import build_model
    from repro_torch.serving import DecodeBatch
    dev = _card()
    cfg = SMOKES[arch]
    cpu = build_model(cfg, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    n = 20
    toks = torch.randint(0, cfg.vocab, (1, n + 3), generator=g)
    batch = {"tokens": toks[:, :n]}
    if cfg.family == "vlm":
        batch = {"inputs_embeds": torch.randn(1, n, cfg.d_model, generator=g)}
    if cfg.enc_layers:
        batch["src_embeds"] = torch.randn(1, 8, cfg.d_model, generator=g)
    outs = []
    for m in (card, cpu):
        lg, caches = m.prefill(batch)
        db = DecodeBatch(m, capacity=n + 4, max_slots=1)
        db.add(0, caches, n, first_token=0)
        steps = [lg]
        for s in range(3):
            lg, _ = m.decode_step(db._stacked, toks[:, n + s:n + s + 1],
                                  n + s)
            steps.append(lg)
        outs.append(torch.cat([x[..., :cfg.vocab].float().cpu()
                               for x in steps]))
    scale = float(outs[1].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4 * scale


# ------------------------------------------------------ attention backward
#: the four backward cases of chip_smoke.py's phase 2, narrowed in batch:
#: (B, T, S, D, H, map, mask keywords)
BWD_CASES = {
    "1g-smollm": (2, 1024, 1024, 64, 16, [min(h // 3, 4) for h in range(16)],
                  dict(causal=True)),
    "1s-starcoder2": (1, 512, 512, 128, 32,
                      [min(h // 12, 1) for h in range(32)],
                      dict(causal=True)),
    "1r-window-d256": (1, 700, 700, 256, 16, [0] * 16,
                       dict(causal=True, window=256)),
    "1x-cross": (2, 256, 64, 64, 16, None, dict(causal=False)),
}


def _bwd_inputs(dev, name, tdt):
    from repro_torch.kernels.flash_attention import _forward
    B, T, S, D, H, kv, mask = BWD_CASES[name]
    Hk = max(kv) + 1 if kv else H
    g = torch.Generator(device=dev).manual_seed(T + D)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(tdt)
    k, v = (torch.randn(B, S, Hk, D, generator=g, device=dev).to(tdt)
            for _ in range(2))
    dout = torch.randn(B, T, H, D, generator=g, device=dev).to(tdt)
    kw = dict(dict(causal=True, window=0, q_offset=0, scale=None), **mask,
              kv_map=None if kv is None else torch.tensor(
                  kv, dtype=torch.int32, device=dev))
    out, lse = _forward(q, k, v, with_lse=True, **kw)
    return (q, k, v, out, lse, dout), kv, kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BWD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_kernel_matches_plain_on_card(name, dtype):
    """dq/dk/dv of the backward kernel against its plain version on the
    same inputs, and the forward's row lse against the plain lse (1e-4:
    float32 sums of the same products in another order)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_lse_plain)
    dev = _card()
    (q, k, v, out, lse, dout), kv, kw = _bwd_inputs(dev, name,
                                                   DTYPES[dtype])
    torch.testing.assert_close(lse, flash_attention_lse_plain(q, k, **kw),
                               atol=1e-4, rtol=1e-4)
    got = flash_attention_bwd(q, k, v, out, lse, dout, kv_map_host=kv, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_.float(), w.float(), atol=_tol(dtype),
                                   rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_attention_bwd_kernel_is_bitwise_repeatable_on_card(name):
    """No float atomics: two calls give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    dev = _card()
    args, kv, kw = _bwd_inputs(dev, name, torch.bfloat16)
    a = flash_attention_bwd(*args, kv_map_host=kv, **kw)
    b = flash_attention_bwd(*args, kv_map_host=kv, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_attention_grad_through_a_map_needs_its_host_copy_on_card():
    from repro_torch.kernels.flash_attention import flash_attention
    dev = _card()
    q = torch.randn(1, 64, 16, 64, device=dev, requires_grad=True)
    k, v = (torch.randn(1, 64, 5, 64, device=dev) for _ in range(2))
    m = torch.tensor([min(h // 3, 4) for h in range(16)], dtype=torch.int32,
                     device=dev)
    with pytest.raises(ValueError, match="kv_map_host"):
        flash_attention(q, k, v, kv_map=m)


@pytest.mark.cuda
def test_smoke_train_step_matches_cpu_on_card():
    """One train step of the smollm smoke model in float32, the same weights
    and batch on the card (the attention kernels, forward and backward) and
    on the CPU: the loss, the norm and the updated parameters. The first
    Adam step moves an element by lr g/(|g| + eps), ill-conditioned where
    |g| is within ~100 eps of 0; such elements are held to lr, the rest to
    1e-4 of each parameter's largest value."""
    from repro_torch.configs import SMOKES
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step)
    from repro_torch.training.trainer import TrainState
    dev = _card()
    cfg = SMOKES["smollm-360m"]
    opt = AdamWConfig(lr=1e-3, warmup=1)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    batch = synthetic_batch(cfg, 2, 64, seed=0, step=0, device="cpu")
    res = []
    for m in (card, cpu):
        m.requires_grad_(True)
        params = dict(m.named_parameters())
        state = TrainState(params, adamw_init(params, opt), 0)
        state, met = make_train_step(m, opt)(
            state, {k: v.to(m.device) for k, v in batch.items()})
        res.append((state, {k: float(v) for k, v in met.items()}))
    (sc, mc), (sp, mp) = res
    assert mc["loss"] == pytest.approx(mp["loss"], rel=1e-5)
    assert mc["grad_norm"] == pytest.approx(mp["grad_norm"], rel=1e-4)
    for n, want in sp.params.items():
        got = sc.params[n].detach().cpu()
        ill = (sp.opt.m[n].abs() / (1 - opt.b1)) <= 1e-6
        d = (got - want.detach()).abs()
        assert float(torch.where(ill, d, 0.0).max()) <= 1.01 * opt.lr, n
        assert float(torch.where(ill, 0.0, d).max()) <= 1e-4 * float(
            want.detach().abs().max()) + 1e-7, n
