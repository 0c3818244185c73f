"""The decode-step calibration gate for the port (the JAX package's
``test_decode_step_time_calibrated_against_kernel_roofline`` in
``tests/test_kernels.py``): the smooth decode model
``StageProfile.decode_step_time`` against the roofline of the port's
decode kernel (``decode_step_roofline``, through
``decode_attention_cost``), for every
paper model on the H100 and A100 profiles; both held to JAX's; and the
bytes the kernel really moves (``decode_attention_traffic``) at off-tile
lengths against the cost model's count, and ``chip_smoke.py`` phase 8's
arithmetic on stand-in times."""
import sys
from pathlib import Path

import pytest
import torch

from repro.core.stages import GroupPlan as JGroupPlan
from repro.core.stages import ParallelismSpec as JParallelismSpec
from repro.core.stages import StageProfile as JStageProfile
from repro.simcluster.hw import A100 as JA100
from repro.simcluster.papermodels import PAPER_MODELS as JPAPER_MODELS
from repro_torch.core.stages import GroupPlan, ParallelismSpec, StageProfile
from repro_torch.kernels.decode_attention import (TILE, decode_attention_cost,
                                                  decode_attention_traffic,
                                                  split_plan)
from repro_torch.simcluster.hw import A100, H100
from repro_torch.simcluster.papermodels import PAPER_MODELS

#: the JAX test's grid: decode batch sizes and mean contexts, which
#: straddle the kernel's 64-key tiles and 256-key blocks
NS = (1, 4, 16, 64)
CTXS = (200, 1000, 3000, 4096, 20000)
MODEL_ERROR = 0.15
#: the H100's SMs, which ``split_plan`` takes (``attn_split.sm_count`` on
#: the card)
H100_SMS = 132


def _cap(D):
    """The kernel's query heads a block at head dim D
    (``decode_attention.cu``: ``Layout::kCap``, 256 threads in groups of
    D / 8, 4 heads a thread)."""
    return 256 // (D // 8) * 4


def _profile(cls, models, hw, name):
    m = models[name]
    par = (ParallelismSpec if cls is StageProfile else JParallelismSpec)(
        mode="ep", ep=4)
    plan = (GroupPlan if cls is StageProfile else JGroupPlan).build(
        m.n_layers, 8)
    return cls(m, hw, par, plan)


@pytest.mark.parametrize("hw", [H100, A100], ids=["h100", "a100"])
@pytest.mark.parametrize("name", sorted(PAPER_MODELS))
def test_decode_model_tracks_the_kernel_roofline(name, hw):
    prof = _profile(StageProfile, PAPER_MODELS, hw, name)
    errs = []
    for n in NS:
        for ctx in CTXS:
            a = prof.decode_step_time(n, ctx)
            r = prof.decode_step_roofline(n, ctx)
            errs.append(abs(a - r) / r)
            # the kernel's attention flops and its q/out bytes only add
            assert r >= a * (1 - 1e-9), (n, ctx, a, r)
    assert max(errs) < MODEL_ERROR, f"decode model error {max(errs):.4f}"


@pytest.mark.parametrize("name", sorted(PAPER_MODELS))
def test_decode_model_and_roofline_against_jax(name):
    """The smooth model is a byte copy, so it equals JAX's exactly; the
    port's roofline counts the keys the kernel reads where JAX's pads them
    to its blocks and 128 lanes, so it never exceeds JAX's."""
    prof = _profile(StageProfile, PAPER_MODELS, A100, name)
    jprof = _profile(JStageProfile, JPAPER_MODELS, JA100, name)
    for n in NS:
        for ctx in CTXS:
            assert prof.decode_step_time(n, ctx) == \
                jprof.decode_step_time(n, ctx)
            assert prof.decode_step_roofline(n, ctx) <= \
                jprof.decode_step_roofline(n, ctx), (n, ctx)


def _cost_bytes(Hk, D, lengths, b):
    return sum(decode_attention_cost(1, Hk, D, n, dtype_bytes=b)[1]
               for n in lengths)


@pytest.mark.parametrize("case", [
    # the JAX test's off-block case: 2 sequences, 4 MHA heads, D=64, S=300
    dict(B=2, H=4, Hk=4, D=64, S=300, lengths=[300, 10], b=4, kv_map=None),
    # phase 2's row 2g: smollm-360m's 16 query heads (15 padded to 16)
    # over 5 KV heads, row 2's lengths, bf16
    dict(B=8, H=16, Hk=5, D=64, S=1024,
         lengths=[1, 1024, 0, 17, 128, 129, 512, 1000], b=2,
         kv_map=[min(h // 3, 4) for h in range(16)]),
], ids=["jax-S300", "gqa-16-over-5"])
def test_traffic_mirror_counts_the_keys_read(case):
    B, H, Hk, D, S, lengths, b = (case[k] for k in ("B", "H", "Hk", "D", "S",
                                                    "lengths", "b"))
    t = decode_attention_traffic(B, H, Hk, D, S, lengths, cap=_cap(D),
                                 sms=H100_SMS, dtype_bytes=b,
                                 kv_map=case["kv_map"])
    _, n_split, _ = split_plan(B, H, Hk, S, cap=_cap(D), sms=H100_SMS)
    assert t["n_split"] == n_split > 1
    # every K/V row below each length, once, and none past it
    assert t["kv"] == 2 * sum(lengths) * Hk * D * b
    # the cost model's K/V term is those reads exactly; beside them it
    # counts one q and one output vector a KV head and sequence (and, at a
    # length of 0, one key: it floors the context at 1)
    zeros = sum(1 for n in lengths if n == 0)
    assert _cost_bytes(Hk, D, lengths, b) == \
        t["kv"] + (B + zeros) * 2 * Hk * D * b
    # what the cost model leaves out: q loaded by every chunk's block for
    # each query head, the output of every query head, and the chunks'
    # float32 partials with their log-sum-exps, written, then read by the
    # combine kernel
    assert t["q"] == n_split * B * H * D * b
    assert t["out"] == B * H * D * b
    assert t["partials"] == 2 * n_split * B * H * (D + 1) * 4


def test_traffic_mirror_counts_a_headless_blocks_first_tile():
    """A KV head no query head reads (a rank's map at model_par 2, row
    2r1's 2, 3, 3, 3, 4, 4, 4, 4) still has its blocks, and each has issued
    its first tile's copy before it finds no head; one SM keeps a single
    chunk, with no partials."""
    kv_map, D, S, n = [2, 3, 3, 3, 4, 4, 4, 4], 64, 300, 300
    t = decode_attention_traffic(1, 8, 5, D, S, [n], cap=_cap(D), sms=1,
                                 dtype_bytes=2, kv_map=kv_map)
    assert t["n_split"] == 1 and t["partials"] == 0
    assert t["kv"] == 2 * (3 * n + 2 * TILE) * D * 2
    assert t["q"] == t["out"] == 8 * D * 2


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_phase8_prints_the_clock_from_stand_in_times(capsys):
    """``chip_smoke.py`` phase 8 is host arithmetic over the times the card
    phases take: on stand-in times it prints the measured share of peak
    (the modeled FLOPs of 4 x 1024 tokens over 989 TFLOP/s times the
    time), each decode row's cost-model bytes over its lengths (phase 2's
    defaults resolved from ``decode_case``), and refuses a share above
    1."""
    cs = _chip_smoke()
    flops, _ = cs.prefill_modeled(cs._arch("minitron-8b"))
    rows = [("2g", torch.bfloat16, dict(kv_heads=5), {"ms": 0.0136}),
            ("2q8", torch.bfloat16, dict(H=48, D=128, S=cs.QWEN_S,
                                         kv_heads=40, kv_map=list(range(48)),
                                         lengths=cs.QWEN_LENGTHS, int8=True),
             {"ms": 1.84})]
    steps = [(1, 8, 32428.5, 0.0467, 44.9)]
    cs.phase_clock("stand-in", {"minitron-8b": (0.25, 0.2)}, rows, steps,
                   cap=_cap, sms=H100_SMS)
    out = capsys.readouterr().out
    assert f"mfu_measured {flops / (989e12 * 0.25):.4f}" in out
    cost = _cost_bytes(5, 64, cs.row2_lengths(1024), 2)
    assert f"2g bfloat16: cost {cost / 1e6:.4f} MB" in out
    cost = _cost_bytes(40, 128, cs.QWEN_LENGTHS, 1)     # int8: 1 byte
    assert f"2q8 bfloat16 K/V int8: cost {cost / 1e6:.4f} MB" in out
    assert "int8 K/V, B=8" in out
    with pytest.raises(SystemExit, match="share of peak"):
        cs.phase_clock("stand-in", {"minitron-8b": (0.01, 0.01)}, [], [],
                       cap=_cap, sms=H100_SMS)
