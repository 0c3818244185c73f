"""The control, the reference one precision below the configuration's
(float8 products for bf16), fails the check that a sound run passes: on
the CPU at the tiny size against the float32 program, and on the card
(marker ``cuda``) against the bf16 program at a small size."""
import pytest
import torch

import conftest as C
from perfbench.drivers import common, decode, serve, train
from perfbench.lib import harness, traffic


def _ctx(drv_mix_cell, cfg, device, seed, seconds=1.0):
    _, mix, cell = drv_mix_cell
    return harness.Ctx(cell="c", cfg=cfg, mix=mix, params=cell, seed=seed,
                       seconds=seconds, trace=False, device=device)


def _served_readings(drv, mix, cell, cfg, device, seed, seconds=1.0):
    ctx = _ctx((drv, mix, cell), cfg, device, seed, seconds)
    rec = drv.run(ctx)
    low = common.served_gap(cfg, seed, device, rec["checked"], "fp8")
    return rec["compared"]["logit_gap"], low


def _train_readings(cfg, device, seed):
    ctx = _ctx((train, C.TRAIN_MIX, C.TRAIN_CELL), cfg, device, seed)
    rec = train.run(ctx)
    batches = traffic.train_tokens(C.TRAIN_MIX, seed, cfg["vocab_size"],
                                   device)[:C.TRAIN_CELL["checked_steps"]]
    ref = train.reference(cfg, seed, batches, device)
    low = train.compare(train.reference(cfg, seed, batches, device, "fp8"),
                        ref)
    return rec["compared"], low


#: long enough outputs over a vocab wide enough that float8 puts another
#: token first somewhere among ~100 served positions (on the CPU a window
#: of 3 s, so that a loaded host still finishes enough of them)
LONG_OUT = {"dist": "lognormal", "median": 16, "sigma": 0.3, "min": 8,
            "max": 24}
LONG_DECODE = (decode, dict(C.DECODE_MIX, output=LONG_OUT),
               dict(C.DECODE_CELL, check_sequences=6))


@pytest.mark.parametrize("kind", ["serve", "decode"])
def test_served_control_fails_cpu(kind):
    drv, mix, cell = {
        "serve": (serve, dict(C.SERVE_MIX, output=LONG_OUT),
                  dict(C.SERVE_CELL, check_requests=8)),
        "decode": LONG_DECODE}[kind]
    got, low = _served_readings(drv, mix, cell,
                                dict(C.TINY, vocab_size=8192), "cpu",
                                2 ** 31 + 21, seconds=3.0)
    limit = cell["limits"]["logit_gap"]
    assert got <= limit < low


def test_train_control_fails_cpu():
    got, low = _train_readings(dict(C.TINY), "cpu", 2 ** 31 + 23)
    limits = C.TRAIN_CELL["limits"]
    assert all(got[k] <= limits[k] for k in limits)
    assert any(low[k] > limits[k] for k in limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


SMALL_BF16 = dict(C.TINY, hidden_size=1024, intermediate_size=4096,
                  num_attention_heads=16, num_key_value_heads=4,
                  head_dim=64, vocab_size=8192, num_hidden_layers=4,
                  torch_dtype="bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_served_control_separates_on_card(card, seed):
    got, low = _served_readings(*LONG_DECODE, dict(SMALL_BF16), card, seed)
    assert low > 3 * got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_train_control_separates_on_card(card, seed):
    got, low = _train_readings(dict(SMALL_BF16), card, seed)
    assert any(low[k] > 3 * got[k] for k in got)
