"""DeepSeek-V3 as published on the port's serving path, held against the
benchmark's plain reference (``perfbench/reference/mla_moe.py``): its
sigmoid group router with the correction bias, YaRN on MLA's rope dims and
its softmax scale, and a layer that holds a share of the experts.

On the CPU, at a small size with seeded random weights loaded as the
benchmark loads them (``perfbench/lib/mla_moe.py``: the published layout,
the rope columns permuted to the port's pairing): a chunked prefill and
then decode through ``DecodeBatch`` against the reference's full forward
logits, within a tolerance that a bf16-degraded reference fails; the
router against a brute-force choice; YaRN's table at the published widths;
the shares of a layer summing to the uncut layer; the permutation.

On the card (marker ``cuda``): the benchmark cell's configuration cut to
two layers (one dense, one expert layer) at its 128 slots x 8192, its
graph replay equal to an eager loop bitwise over 45 steps with one host
sync a step, no per-token weight gather in its memory, and its device
sections within the step's device time. Imports neither ``jax`` nor the
JAX package.
"""
import dataclasses
import itertools
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import blocks
from repro_torch.models.arch import PortArch, Yarn, settings
from repro_torch.models.layers import apply_rope, rope
from repro_torch.serving import DecodeBatch, ServingEngine
from repro_torch.tracing import REC, recording

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers.decode_steady import chunked_prefill  # noqa: E402
from perfbench.lib import mla_moe, spec, traffic  # noqa: E402
from perfbench.reference import mla_moe as reference  # noqa: E402

PUBLISHED = json.loads((ROOT / "perfbench/configs/deepseek-v3.json")
                       .read_text())
#: the cell's configuration at a small size: 16 published experts in 4
#: groups of 4 (2 kept), top-4, this layer holding experts 4-7; rope 16
#: dims, so that YaRN's ramp (dims 2 to 6 at 4096 original positions) is
#: inside them
TINY = dict(PUBLISHED, name="tiny-v3", hidden_size=64, intermediate_size=128,
            kv_lora_rank=16, moe_intermediate_size=32, n_group=4,
            topk_group=2, n_routed_experts=4, held_first=4,
            num_attention_heads=4, num_key_value_heads=4,
            num_experts_per_tok=4, num_hidden_layers=3,
            first_k_dense_replace=1, q_lora_rank=24, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, vocab_size=512,
            torch_dtype="float32", router_bias_std=0.05,
            published=dict(PUBLISHED["published"], n_routed_experts=16))
#: logits of the float32 port against the float32 reference: the two order
#: their sums differently (absorbed against non-absorbed attention, the
#: experts batched against one by one), ~4e-6 apart on logits of ~4; a
#: bf16 reference is ~1e-2 off
TOL = 1e-4
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def tiny():
    leaves = mla_moe.make(TINY, SEED, "cpu")
    return leaves, mla_moe.build(TINY, leaves, "cpu")


def _decoded(model, prompts, steps, chunk=8):
    """Each prompt prefilled in chunks and decoded ``steps`` steps in one
    ``DecodeBatch``: (prompt, served tokens, logits at each served
    token's position) a prompt."""
    eng = ServingEngine(model)
    db = DecodeBatch(model, capacity=64, max_slots=len(prompts))
    out = []
    for k, p in enumerate(prompts):
        first, cache = chunked_prefill(eng, p, chunk)
        db.add(k, cache, len(p), first, max_new=steps + 1)
        _, _, logits = eng.prefill(p)
        out.append((p, [first], [logits[0, -1]]))
    for _ in range(steps):
        got = db.step()
        for k, (_, toks, logits) in enumerate(out):
            logits.append(db.logits[k])
            toks.append(got[k])
    return [(p, t, torch.stack(lg)) for p, t, lg in out]


def _reference_logits(leaves, prompt, served, cfg=TINY):
    toks = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    at = range(len(prompt) - 1, len(prompt) - 1 + len(served))
    return reference.logits_at(cfg, leaves, toks, list(at))


def test_prefill_and_decode_match_the_reference(tiny):
    leaves, model = tiny
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (19, 5, 30)]
    worst = 0.0
    for prompt, served, logits in _decoded(model, prompts, steps=6):
        ref = _reference_logits(leaves, prompt, served)
        assert ref.shape == logits.shape == (len(served), 512)
        worst = max(worst, float((logits - ref).abs().max()))
        # every served token is the reference's first choice
        assert torch.equal(ref.argmax(-1), torch.as_tensor(served))
    assert worst < TOL, worst


def _bf16_mm(a, w, precision):
    return (a.bfloat16() @ w.bfloat16()).float()


def test_tolerance_fails_a_bf16_reference(tiny, monkeypatch):
    leaves, model = tiny
    prompt = np.random.default_rng(2).integers(0, 512, size=24)
    (_, served, logits), = _decoded(model, [prompt], steps=4)
    exact = _reference_logits(leaves, prompt, served)
    monkeypatch.setattr(reference, "_mm", _bf16_mm)
    low = _reference_logits(leaves, prompt, served)
    assert float((low - logits).abs().max()) > 10 * TOL
    assert float((exact - logits).abs().max()) < TOL


# ---------------------------------------------------------------- router
def _brute_force(scores, bias, cfg):
    """The router by enumeration: of every choice of ``topk_group`` groups,
    the one with the largest sum of group scores (each the sum of its two
    best biased scores), then the ``top_k`` largest biased scores within
    it; gates the unbiased scores over their sum, times the scale."""
    E = scores.shape[0]
    G, per = cfg["n_group"], E // cfg["n_group"]
    biased = [float(s + b) for s, b in zip(scores, bias)]
    gscore = [sum(sorted(biased[g * per:(g + 1) * per])[-2:])
              for g in range(G)]
    kept = max(itertools.combinations(range(G), cfg["topk_group"]),
               key=lambda c: sum(gscore[g] for g in c))
    cand = [e for g in kept for e in range(g * per, (g + 1) * per)]
    chosen = sorted(cand, key=lambda e: -biased[e])
    chosen = chosen[:cfg["num_experts_per_tok"]]
    g = np.array([float(scores[e]) for e in chosen])
    return set(chosen), dict(zip(chosen, g / g.sum()
                                 * cfg["routed_scaling_factor"]))


def _route_both(logit, bias):
    """(port's, reference's) choice for one token whose router logits are
    ``logit``: the router is the identity over 16 inputs."""
    x = torch.as_tensor(logit, dtype=torch.float32)[None]
    router = torch.eye(16)
    b = torch.as_tensor(bias, dtype=torch.float32)
    port = blocks._routing(x, router, b, mla_moe.arch(TINY))
    ref = reference.route(x, router, b, TINY)
    return port, ref


def _check(logit, bias):
    scores = torch.sigmoid(torch.as_tensor(logit, dtype=torch.float32))
    want, gates = _brute_force(scores, torch.as_tensor(bias), TINY)
    for g, idx in _route_both(logit, bias):
        assert set(idx[0].tolist()) == want
        for e, v in zip(idx[0].tolist(), g[0].tolist()):
            assert v == pytest.approx(gates[e], rel=1e-6)
    return want


def test_router_bias_flips_a_choice():
    # groups {0-3} {4-7} {8-11} {12-15}; groups 0 and 1 lead by far
    logit = [3, 2.9, 2, 1, 3, 1.9, 0.5, 0.4, -3, -3, -3, -3, -3, -3, -3, -3]
    no_bias = _check(logit, [0.0] * 16)
    assert no_bias == {0, 1, 2, 4}
    bias = [0.0] * 16
    bias[5] = 0.06                      # 5's biased score passes 2's
    assert _check(logit, bias) == {0, 1, 4, 5}


def test_group_limit_excludes_a_top_expert():
    # expert 12 has the fourth-largest score of all, but its group's two
    # best sum below groups 0's and 1's: it is not chosen
    logit = [3, 2.9, 2.8, 2.7, 2.6, 2.5, 0.0, 0.0,
             -3, -3, -3, -3, 2.95, -3, -3, -3]
    got = _check(logit, [0.0] * 16)
    assert 12 not in got and got == {0, 1, 2, 3}
    top4 = sorted(range(16), key=lambda e: -logit[e])[:4]
    assert 12 in top4


def test_default_router_is_the_softmax_one():
    cfg = PortArch(name="x", family="moe", n_layers=1, d_model=8, n_heads=1,
                   n_kv=1, d_ff=8, vocab=8, n_experts=4, top_k=2)
    x, router = torch.randn(5, 8), torch.randn(8, 4)
    for a, b in zip(blocks._routing(x, router, None, cfg),
                    blocks._route(x, router, 2)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- YaRN
def test_yarn_table_at_published_widths():
    rs = PUBLISHED["rope_scaling"]
    y = settings(mla_moe.arch(PUBLISHED)).yarn
    assert y == Yarn(factor=40, original=4096, beta_fast=32, beta_slow=1,
                     mscale=1, mscale_all_dim=1)
    assert y.bounds(64, 10000) == (10, 23) == reference.yarn_bounds(PUBLISHED)
    assert y.softmax_scale == pytest.approx(1.8738, abs=1e-4)
    assert y.softmax_scale == pytest.approx(
        (0.1 * math.log(rs["factor"]) + 1) ** 2, rel=1e-12)
    assert reference.softmax_scale(PUBLISHED) == pytest.approx(
        192 ** -0.5 * 1.8738, abs=1e-5)
    assert y.rope_scale == 1.0
    f = y.inv_freq(64, 10000)
    base = 1.0 / 10000 ** (torch.arange(32) / 32)
    assert torch.equal(f[:11], base[:11].float())
    torch.testing.assert_close(f[23:], base[23:].float() / 40)
    assert all(base[i] / 40 < f[i] < base[i] for i in range(11, 23))
    torch.testing.assert_close(f, reference.yarn_freqs(PUBLISHED))


def test_rope_permutation_maps_the_published_pairing():
    """The port's half-split rotation of the permuted rope dims is the
    published interleaved rotation, permuted the same way."""
    dim = 16
    perm = mla_moe.rope_perm(dim)
    assert perm.tolist() == [0, 2, 4, 6, 8, 10, 12, 14,
                             1, 3, 5, 7, 9, 11, 13, 15]
    x = torch.randn(7, 3, dim)
    pos = torch.arange(40, 47)
    want = reference.rope(x, pos, TINY)[..., perm]
    sin, cos = rope(pos[None], dim, 10000.0,
                    settings(mla_moe.arch(TINY)).yarn)
    got = apply_rope(x[..., perm][None], sin, cos)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # without the permutation the two pair other dims
    assert (apply_rope(x[None], sin, cos)[0] - reference.rope(
        x, pos, TINY)).abs().max() > 1e-2


# ---------------------------------------------------------------- shares
def _holding(held):
    """The tiny configuration with its layers holding ``held``: (first,
    count) of the 16 experts, (0, 0) for all."""
    cfg = mla_moe.arch(TINY)
    return dataclasses.replace(cfg, port=dataclasses.replace(
        settings(cfg), held=held))


def _moe(held, full):
    """An expert layer holding ``held`` of 16, weights the rows of
    ``full``'s."""
    cfg = _holding(held)
    m = blocks.MoE(cfg, dtype=torch.float32, device="cpu")
    lo, n = held
    with torch.no_grad():
        for name in ("router", "router_bias"):
            getattr(m, name).copy_(getattr(full, name))
        for name in ("w_in", "w_gate", "w_out"):
            getattr(m, name).copy_(getattr(full, name)[lo:lo + n])
        for a, b in zip(m.shared.parameters(), full.shared.parameters()):
            a.copy_(b)
    return m, cfg


@pytest.mark.parametrize("mode,shape", [("prefill", (2, 9)),
                                        ("decode", (6, 1))])
def test_shares_sum_to_the_uncut_layer(mode, shape):
    g = torch.Generator().manual_seed(5)
    cfg_full = _holding((0, 0))
    full = blocks.MoE(cfg_full, dtype=torch.float32, device="cpu")
    full.init(g)
    with torch.no_grad():
        full.router_bias.normal_(generator=g).mul_(0.05)
    x = torch.randn(*shape, 64, generator=g)
    whole = blocks.moe_apply(full, x, cfg=cfg_full, mode=mode)
    parts, shared = [], full.shared(x)
    for lo in range(0, 16, 4):
        m, c = _moe((lo, 4), full)
        parts.append(blocks.moe_apply(m, x, cfg=c, mode=mode))
        if mode == "decode":
            assert m.held_pairs.shape == (4,)
    total = sum(parts) - (len(parts) - 1) * shared
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
    assert float((whole - shared).abs().max()) > 1e-3   # the experts work
    if mode == "decode":
        assert int(full.held_pairs.sum()) == 6 * 4        # N x top-k


def test_held_experts_decode_equals_a_loop_over_tokens(tiny):
    """The gather-free decode path against every token through its own
    held experts one by one, gated and summed."""
    _, model = tiny
    p, cfg = model.seg1[0][0].ffn_moe, model.cfg
    x = torch.randn(9, 64, generator=torch.Generator().manual_seed(8))
    gates, idx = blocks._routing(x, p.router, p.router_bias, cfg)
    want = torch.zeros_like(x)
    pairs = torch.zeros(4, dtype=torch.int32)
    for n in range(9):
        for k in range(cfg.top_k):
            e = int(idx[n, k]) - p.lo
            if 0 <= e < 4:
                h = torch.nn.functional.silu(x[n] @ p.w_gate[e]) * \
                    (x[n] @ p.w_in[e])
                want[n] += gates[n, k] * (h @ p.w_out[e])
                pairs[e] += 1
    got, held = blocks._held_ffn(p.w_in, p.w_gate, p.w_out, x, gates, idx,
                                 p.lo)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(held, pairs) and int(pairs.sum()) > 0


def test_loader_fills_every_parameter_once(tiny):
    leaves, model = tiny
    assert sum(t.numel() for t in leaves.values()) == mla_moe.n_params(TINY)
    assert model.seg1[0][0].ffn_moe.w_in.shape == (4, 64, 32)
    assert model.seg1[0][0].ffn_moe.router.shape == (64, 16)
    with pytest.raises(ValueError):
        mla_moe.arch(dict(TINY, scoring_func="softmax"))


def test_published_size():
    """5.94 B parameters as run: 187.1 M of MLA a layer, 396.4 M of dense
    MLP, 352.3 M of 8 experts, 44.0 M shared, 1.8 M of router; 926.7 M
    each for the embedding and the head."""
    n = mla_moe.n_params(PUBLISHED)
    assert abs(n - 5.94e9) < 0.01e9, n


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


CELL = "deepseek-v3.decode-reason-128"


def _cell_requests(device, seed=2147483671):
    """The cell's configuration cut to one dense and one expert layer,
    weights from the seed, and its pool's prompts prefilled in chunks,
    the first fill's outputs ramped as ``perfbench/drivers/decode.py``
    ramps them."""
    bench = spec.benchmark()
    w = spec.workload(bench, CELL)
    cfg = dict(spec.config(bench, w["config"]), num_hidden_layers=2,
               first_k_dense_replace=1)
    P = spec.cell_params(CELL)
    model = mla_moe.build(cfg, mla_moe.make(cfg, seed, device), device)
    eng = ServingEngine(model)
    pool = traffic.decode_pool(spec.traffic(w["traffic"]), seed,
                               cfg["vocab_size"], P["capacity"])
    reqs = []
    for k, s in enumerate(pool):
        first, cache = chunked_prefill(eng, s.tokens, P["prefill_chunk"])
        out = max(2, round(s.max_new * (k + 1) / P["slots"]))
        reqs.append((len(s.tokens), cache, first, out))
    return model, reqs, P["slots"], P["capacity"]


@pytest.mark.cuda
def test_cell_graph_equals_eager_loop_and_sections_fit(card):
    from test_torch_decode_graph import STEPS, _graph_against_eager
    REC.clear()
    model, reqs, slots, capacity = _cell_requests(card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    retired = _graph_against_eager(model, reqs, slots, capacity)
    peak = torch.cuda.max_memory_allocated() - base
    # the eager loop's copy of the caches, the batch's own, and a step's
    # intermediates (a layer's float32 latents, 2.1 GB); a per-token gather
    # of 8 experts' weights for 128 tokens would be 90 GB
    caches = 2 * 2 * slots * capacity * 1152
    assert peak < caches + 8e9, (peak, caches)
    steps = len({i for _, _, _, i in REC.times})
    assert steps == STEPS - 1                  # every replay filed
    for name in ("mla.attend", "moe.experts"):
        n = sum(1 for t in REC.times if t[1] == name)
        assert n == (STEPS - 1) * (2 if name == "mla.attend" else 1), name
    assert retired > 0
    # a replay's sections lie inside its device time
    db = DecodeBatch(model, capacity=capacity, max_slots=slots)
    for k in range(slots):
        n, cache, first, _ = reqs[k % len(reqs)]
        db.add(k, cache, n, first, max_new=10 ** 6)
    db.step()
    REC.clear()
    with recording():
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            db.step()
            b.record()
            b.synchronize()
            step_ms = a.elapsed_time(b)
            sections = sum(ms for _, _, ms, i in REC.times
                           if i == db.n_steps)
            assert 0 < sections <= step_ms, (sections, step_ms)
        assert REC.counted("host_syncs") == 5
        pairs = [n for _, c, n in REC.bumps if c == "moe_held_pairs"]
        assert len(pairs) == 5 * 8 and sum(pairs) > 0
    print(f"deepseek-v3 at 2 layers, {slots} slots x {capacity}: peak "
          f"{peak / 1e9:.2f} GB over the weights, {retired} retired; last "
          f"step {step_ms:.3f} ms on the device, sections {sections:.3f} ms,"
          f" pairs {pairs[-8:]}")
