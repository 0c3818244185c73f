"""Operation and byte counts against shapes worked by hand."""
import json

import pytest

from conftest import ROOT
from perfbench.lib import counts, spec

SMALL = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 16,
         "vocab_size": 10}


def test_causal_pairs():
    assert counts.causal_pairs(3) == 6           # 1 + 2 + 3
    assert counts.causal_pairs(2, 5) == 13       # 6 + 7


def test_layer_params_by_hand():
    # q 8x8, k and v 8x4, o 8x8, three 8x16 MLP matrices
    assert counts.layer_matrix_params(SMALL) == 64 + 64 + 64 + 384
    assert counts.params(SMALL) == 2 * 80 + 2 * (576 + 16) + 8


def test_prefill_flops_by_hand():
    # 3 new tokens after 2: per layer 2*576*3 products, 4*4*2 per pair
    # over 3 + 4 + 5 pairs; the last position's logits 2*8*10
    want = 2 * (2 * 576 * 3 + 32 * 12) + 160
    assert counts.prefill_flops(SMALL, 3, 2) == want


def test_decode_and_train_flops_by_hand():
    assert counts.decode_flops(SMALL, [4, 7]) == \
        2 * (2 * 2 * 576 + 160) + 2 * 32 * 11
    fwd = 2 * (2 * 576 * 2 * 3 + 32 * 2 * 6) + 160 * 6
    assert counts.train_flops(SMALL, 2, 3) == 3 * fwd


def test_attention_work_by_hand():
    f, b = counts.flash_fwd_work(SMALL, 1, 3, 2)
    assert f == 32 * 12
    assert b == 2 * (2 * 3 * 8 + 2 * 5 * 4)      # q, out; k, v over 5 keys
    f, b = counts.decode_attn_work(SMALL, [4, 7])
    assert f == 32 * 11 and b == 2 * (2 * 4 * 11 + 2 * 2 * 8)
    f, b = counts.flash_bwd_work(SMALL, 1, 3)
    assert f == 2.5 * 32 * 6
    assert b == 2 * (3 * 24 + 2 * 12) + 4 * 12 + 2 * (24 + 2 * 12)


def test_bound_and_roofline():
    t, term = counts.bound_s(989e12, 1.0)
    assert t == pytest.approx(1.0) and term == "operations"
    t, term = counts.bound_s(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and term == "bytes"
    pct, term = counts.roofline_pct([(989e12, 0.0)] * 2, 4.0)
    assert pct == pytest.approx(50.0) and term == "operations"
    assert counts.roofline_pct([], 1.0) is None


def test_published_sizes():
    bench = spec.benchmark()
    mini = spec.config(bench, "minitron-8b")
    sc2 = json.loads((ROOT / "perfbench/configs/starcoder2-3b.json")
                     .read_text())
    assert counts.params(mini) == pytest.approx(10.42e9, rel=0.005)
    assert counts.params(sc2) == pytest.approx(4.3e9, rel=0.02)
    L, d, H, Hkv, hd, *_ = counts.dims(mini)
    assert 2 * L * Hkv * hd * 2 == 128 * 1024   # KV bytes a token
