"""The MLA and expert cell's benchmark side: its driver at a tiny size on
the CPU (a sound run correct, a served token altered not), its counts
against sums worked by hand, its metrics as ``spec`` resolves them, and
its control (the float8 reference) against the bf16 program on the card
(marker ``cuda``)."""
import json

import pytest
import torch

from conftest import ROOT
from perfbench import faults
from perfbench.drivers import decode_steady
from perfbench.lib import harness, mla_moe, spec
from perfbench.lib import mla_moe_counts as mc

CELL = "deepseek-v3.decode-reason-128"
PUBLISHED = json.loads((ROOT / "perfbench/configs/deepseek-v3.json")
                       .read_text())
#: the cell's configuration at a small size (16 published experts in 4
#: groups, 4 held, top-4), float32 on the CPU
TINY = dict(PUBLISHED, name="tiny-v3", hidden_size=64, intermediate_size=128,
            kv_lora_rank=16, moe_intermediate_size=32, n_group=4,
            topk_group=2, n_routed_experts=4, held_first=4,
            num_attention_heads=4, num_key_value_heads=4,
            num_experts_per_tok=4, num_hidden_layers=3,
            first_k_dense_replace=1, q_lora_rank=24, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, vocab_size=512,
            torch_dtype="float32", router_bias_std=0.05,
            published=dict(PUBLISHED["published"], n_routed_experts=16))
MIX = {"kind": "decode_steady", "pool": 6,
       "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8,
                  "max": 48},
       "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 3,
                  "max": 12}}
PARAMS = {"slots": 4, "capacity": 96, "prefill_chunk": 16,
          "warmup_steps": 1, "check_sequences": 3,
          "limits": {"logit_gap": 1e-3}}


def _run(cfg, mix, params, device, seed, fault=None, seconds=1.0):
    ctx = harness.Ctx(cell="t", cfg=cfg, mix=mix, params=params, seed=seed,
                      seconds=seconds, trace=False, device=device,
                      fault=fault)
    return ctx, decode_steady.run(ctx)


def _correct(rec):
    return harness.is_correct(harness.checks_of(rec, PARAMS["limits"]))


def test_sound_run_is_correct():
    _, rec = _run(TINY, MIX, PARAMS, "cpu", 2 ** 31 + 31)
    assert rec["attempted"] > 0 and _correct(rec), rec["compared"]
    assert set(rec["decode"]) == {"gaps_s", "step_calls", "t0_ns", "end_ns"}


def test_altered_token_is_not_correct():
    _, rec = _run(TINY, MIX, PARAMS, "cpu", 2 ** 31 + 31,
                  faults.token_altered(TINY["vocab_size"]))
    assert not _correct(rec), rec["compared"]


def test_steady_start_ramps_the_first_fill():
    from perfbench.lib import traffic
    pool = traffic.decode_pool(MIX, 7, 512, 96)
    ahead = decode_steady.steady_start(MIX, pool, 7, 512, 4)
    for k, a in enumerate(ahead):
        want = min(round(pool[k].max_new * (k + 0.5) / 4),
                   pool[k].max_new - 2)
        assert len(a) == max(want, 0)
    assert [len(a) for a in ahead] != [0] * 4


# ---------------------------------------------------------------- counts
def test_counts_by_hand():
    cfg = PUBLISHED
    assert mc.latent_bytes(cfg) == 1152
    assert mc.mla_pair_flops(cfg) == 2 * 128 * 1088
    f, b = mc.mla_attend_work(cfg, [3, 5])
    assert (f, b) == (2 * 128 * 1088 * 8, 1152 * 8)
    assert mc.expert_bytes(cfg) == 2 * 3 * 7168 * 2048
    f, b = mc.moe_experts_work(cfg, 4)
    assert f == 4 * 6 * 7168 * 2048
    assert b == 2 * 3 * 7168 * 2048 + 4 * 2 * 2 * 7168
    assert mc.moe_experts_work(cfg, 0) == (0.0, 0.0)
    mla = (7168 * 1536 + 1536 * 128 * 192 + 7168 * 576 + 128 * 128 * 512
           + 128 * 512 * 128 + 128 * 128 * 7168)
    # the absorbed W_kb, W_vb are as wide as the published wkv_b: MLA's
    # 187.1 M parameters a layer, norms aside
    assert mla == pytest.approx(187.1e6, rel=1e-3)
    per_token = 2 * (7 * mla + 3 * 3 * 7168 * 18432
                     + 4 * (7168 * 256 + 3 * 7168 * 2048) + 7168 * 129280)
    assert mc.token_flops(cfg) == per_token
    assert mc.decode_flops(cfg, [10, 20], 7) == \
        2 * per_token + 7 * 2 * 128 * 1088 * 30 + 7 * 6 * 7168 * 2048


class _Rec:
    """A recorder with the program's readings: 2 steps, 3 sections."""

    def __init__(self):
        self.times = [(10, "mla.attend", 2.0, 1), (11, "mla.attend", 3.0, 2),
                      (12, "moe.experts", 1.0, 2)]
        self.bumps = [(10, "moe_held_pairs", 3), (11, "moe_held_pairs", 0),
                      (12, "moe_held_pairs", 5), (99, "moe_held_pairs", 9)]

    def section_ms(self, name, t0, t1):
        return [ms for t, c, ms, _ in self.times if c == name
                and t0 <= t <= t1]


def test_readings_by_hand(monkeypatch):
    class W:
        steps = [0, 1]
    trace = type("T", (), {"t0_ns": 0, "t1_ns": 50})()
    record = {"cfg": PUBLISHED, "trace": trace, "decode": {
        "step_calls": [(1, 2, [4, 6]), (3, 4, [5, 7]), (60, 70, [1])]}}
    monkeypatch.setattr(mc, "_window", lambda r: (W, _Rec()))
    assert mc.per_step_ms(record, "mla.attend") == 2.5
    assert mc.per_step_ms(record, "moe.experts") == 0.5
    assert mc.held_pairs(record) == [3, 0, 5]
    assert mc.pairs_per_step(record) == 4.0
    bound = sum(max(f / 989e12, b / 3.35e12) for f, b in
                [mc.mla_attend_work(PUBLISHED, k) for k in ([4, 6], [5, 7])]
                * 7)
    assert mc.mla_roofline(record) == pytest.approx(100 * bound / 5e-3)
    bound = sum(max(f / 989e12, b / 3.35e12) for f, b in
                [mc.moe_experts_work(PUBLISHED, n) for n in (3, 0, 5)])
    assert mc.experts_roofline(record) == pytest.approx(100 * bound / 1e-3)
    flops = (mc.decode_flops(PUBLISHED, [4, 6], 0)
             + mc.decode_flops(PUBLISHED, [5, 7], 8))
    assert mc.mfu(record) == pytest.approx(100 * flops / (2e-9 * 989e12))


def test_no_program_readings_give_no_metric():
    assert mc.per_step_ms({"decode": {}}, "mla.attend") is None
    assert mc.mla_roofline({"decode": {}}) is None
    assert mc.mfu({}) is None


def test_cell_metrics_resolve():
    bench = spec.benchmark()
    e2e = {m["name"] for m in spec.metrics_for(bench, CELL, False)}
    assert e2e == {"tpot_p95_ms", "setup_s"}
    layer = {m["name"] for m in spec.metrics_for(bench, CELL, True)}
    assert layer == {"decode_step_ms", "device_idle.decode",
                     "decode_host_syncs_per_step", "decode_graph_share",
                     "mla_attend_ms", "mla_attend_roofline",
                     "moe_experts_ms", "moe_experts_roofline",
                     "moe_held_pairs_per_step", "decode_mfu.mla_moe"}
    for name in layer:
        assert callable(spec.reader(name).read)
    assert spec.driver(spec.traffic(spec.workload(bench, CELL)["traffic"])
                       ["kind"]) is decode_steady
    # the old cell's metrics are as they were
    old = {m["name"] for m in spec.metrics_for(bench, "minitron-8b.decode-64",
                                               True)}
    assert not old & {"mla_attend_ms", "moe_experts_ms"}


def test_published_keys_kept():
    """Every key of the published config.json, as the file runs it: the
    reduced ones beside their published values."""
    assert set(PUBLISHED["reduced"]) == set(PUBLISHED["published"])
    assert mla_moe.published_experts(PUBLISHED) == 256
    assert PUBLISHED["n_routed_experts"] == 8
    assert mla_moe.n_params(PUBLISHED) == pytest.approx(5.94e9, rel=2e-3)


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


#: the cell's configuration at a width the card runs in seconds, bf16, with
#: outputs long enough for float8 to reorder a served token
SMALL_BF16 = dict(TINY, hidden_size=1024, intermediate_size=2048,
                  kv_lora_rank=128, moe_intermediate_size=256,
                  num_attention_heads=8, num_key_value_heads=8,
                  q_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64, vocab_size=8192, torch_dtype="bfloat16")
LONG = dict(MIX, output={"dist": "lognormal", "median": 16, "sigma": 0.3,
                         "min": 8, "max": 24})


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_separates_on_card(card, seed):
    ctx, rec = _run(SMALL_BF16, LONG, dict(PARAMS, check_sequences=6), card,
                    seed)
    got = rec["compared"]["logit_gap"]
    low = decode_steady.control(ctx, rec)["logit_gap"]
    assert low > 3 * got, (got, low)
