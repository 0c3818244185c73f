"""The port's dry run (``launch/dryrun.py``) on the CPU: a few cells of the
production meshes on the meta device (one of each kind, deepseek-v3's
train at a depth cut, one ``long_500k``, recurrentgemma-9b's
``long_500k``), the command line, and the kernels' meta
branches: outputs of the shapes and dtypes the kernels give (those of
their plain versions on the CPU), no launch, and the operations each
stands for. The dry run's collectives are held to a real mesh's in
tests/test_torch_zero3.py."""
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS
from repro_torch.kernels import meta
from repro_torch.kernels.attn_split import attn_merge
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (_forward, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_lse_plain)
from repro_torch.kernels.ref import attention_mask
from repro_torch.kernels.rglru import (rglru_bwd_cost, rglru_cost, rglru_scan,
                                      rglru_scan_bwd)
from repro_torch.kernels.ssd_scan import (ssd_bwd_cost, ssd_chunked,
                                          ssd_chunked_bwd, ssd_cost)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh

LAUNCHES = (flash_attention, flash_attention_bwd, decode_attention,
            ssd_chunked, ssd_chunked_bwd, rglru_scan, rglru_scan_bwd,
            attn_merge)


def _cell(arch, shape):
    return specs.plan_cells([arch], [shape])[0]


@pytest.mark.parametrize("arch,shape,multi", [
    ("smollm-360m", "train_4k", False),
    ("deepseek-moe-16b", "prefill_32k", True),
    ("qwen1.5-32b", "decode_32k", False),
    ("mamba2-1.3b", "long_500k", True),
])
def test_cells_run_on_the_meta_device(arch, shape, multi):
    mesh = make_production_mesh(multi_pod=multi, dry=True)
    launches = [k.launches for k in LAUNCHES]
    rec = dryrun.run_cell(_cell(arch, shape), mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert [k.launches for k in LAUNCHES] == launches     # nothing ran
    assert rec["mesh"] == ("2podx16datax16model" if multi
                           else "16datax16model")
    assert rec["input_bytes_per_device"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        rec["input_bytes_per_device"]
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    col = rec["collectives"]
    assert col["total_bytes"] == sum(col[k]["bytes"] for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"))
    kernels = rec["cost_analysis"]["kernel_flops"]
    if shape == "train_4k":
        # ZeRO-3: each read gathered, each gradient reduce-scattered
        assert col["reduce-scatter"]["count"] > 0
        assert kernels["flash_attention_bwd"] == pytest.approx(
            2.5 * kernels["flash_attention"] / 2)        # remat: 2 forwards
    if shape == "prefill_32k":                          # the EP dispatch
        assert col["all-to-all"]["count"] > 0 and "meta:" in rec["notes"]
    if shape == "decode_32k":
        # qwen's int8 cache over 2048 of the 32768 slots a rank
        cfg = ARCHS[arch]
        assert kernels["decode_attention"] == pytest.approx(
            cfg.n_layers * 4.0 * 48 * cfg.hd * 8 * 2048)
        assert "attn_merge" in kernels
    if shape == "long_500k":
        assert set(kernels) == {"ssd_chunked"}


def test_deepseek_v3_train_at_a_depth_cut():
    """2D expert parallelism, bf16 moments and ZeRO-3 of the spare axes
    at 3 dense layers and 1 MoE layer (of 61), on the single-pod mesh."""
    cfg = dataclasses.replace(ARCHS["deepseek-v3-671b"], n_layers=4)
    mesh = make_production_mesh(dry=True)
    rec = dryrun.run_cell(_cell("deepseek-v3-671b", "train_4k"), mesh, cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    col = rec["collectives"]
    assert col["all-to-all"]["count"] > 0
    assert col["reduce-scatter"]["count"] > 0
    built = specs.build_cell(_cell("deepseek-v3-671b", "train_4k"), mesh,
                             cfg)
    state = built.args[0]
    assert all(m.dtype == torch.bfloat16 for m in state.opt.m.values())
    w_in = state.params["seg1.0.0.ffn_moe.w_in"]
    assert w_in.shape[0] == 1 and w_in.z3 is None       # 256 experts / 256


def test_counted_flops_are_flop_counter_modes():
    """The step's own operations are counted with FlopCounterMode's
    formulas: the same total as the mode itself over the same step."""
    mesh = make_production_mesh(dry=True)
    cell = specs.build_cell(_cell("smollm-360m", "prefill_32k"), mesh)
    with FlopCounterMode(display=False) as mode:
        cell.fn(*cell.args)
    cell = specs.build_cell(_cell("smollm-360m", "prefill_32k"), mesh)
    with dryrun.StepCounter() as counted:
        cell.fn(*cell.args)
    assert counted.flops == mode.get_total_flops() > 0


def test_families_without_tensor_parallelism_fail_naming_it():
    """Every family the repo ships has tensor parallelism on the production
    mesh: recurrentgemma-9b's long_500k cell runs (RG-LRU's channels and
    the windowed ring's slots over "model"), and a full-attention arch's
    stays JAX's documented skip. A model whose RG-LRU the model axis
    cannot split (a width of no 16 gate blocks) fails, naming why."""
    launches = [k.launches for k in LAUNCHES]
    rec = dryrun.run_cell(_cell("recurrentgemma-9b", "long_500k"),
                          make_production_mesh(dry=True))
    assert rec["status"] == "ok", rec.get("traceback")
    assert [k.launches for k in LAUNCHES] == launches     # nothing ran
    kernels = rec["cost_analysis"]["kernel_flops"]
    assert {"rglru_scan", "decode_attention", "attn_merge"} <= set(kernels)
    rec = dryrun.run_cell(_cell("smollm-360m", "long_500k"),
                          make_production_mesh(dry=True))
    assert rec["status"] == "skip" and "documented skip" in rec["reason"]
    odd = dataclasses.replace(ARCHS["recurrentgemma-9b"], rglru_width=4104)
    rec = dryrun.run_cell(_cell("recurrentgemma-9b", "long_500k"),
                          make_production_mesh(dry=True), odd)
    assert rec["status"] == "fail"
    assert "do not divide RG-LRU's 1 gate blocks" in rec["error"]


def test_command_line_writes_each_mesh(tmp_path, capsys):
    dryrun.main(["--mesh", "both", "--arch", "mamba2-1.3b",
                 "seamless-m4t-medium", "--shape", "long_500k",
                 "decode_32k", "--out", str(tmp_path), "--tag", "_t"])
    out = capsys.readouterr().out
    for name in ("single_pod_16x16", "multi_pod_2x16x16"):
        recs = json.loads((tmp_path / f"dryrun_{name}_t.json").read_text())
        assert [r["status"] for r in recs] == ["ok", "ok", "ok", "skip"]
        assert f"[{name}] done: 3 ok / 1 skip / 0 fail" in out


def _same(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.device.type == "meta"
            assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


def _both(*shapes, dtype=torch.float32):
    g = torch.Generator().manual_seed(len(shapes))
    cpu = [None if s is None else torch.randn(s, generator=g).to(dtype)
           for s in shapes]
    return cpu, [None if t is None else t.to("meta") for t in cpu]


def test_meta_outputs_have_the_kernels_shapes():
    """Each wrapper and backward on meta tensors: the kernel's outputs'
    shapes and dtypes (those of the plain version on the CPU), nothing
    launched, and its operations added to ``meta.FLOPS``: attention's over
    the visible (query, key) pairs, decode's over every slot, the scans'
    their cost formulas'."""
    launches = [k.launches for k in LAUNCHES]
    meta.zero()
    B, T, S, H, Hk, D = 2, 8, 12, 4, 2, 64
    kv_map = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    kw = dict(causal=True, window=5, q_offset=4, scale=None)
    bf = torch.bfloat16
    (q, k, v, do), (mq, mk, mv, mdo) = _both((B, T, H, D), (B, S, Hk, D),
                                             (B, S, Hk, D), (B, T, H, D),
                                             dtype=bf)
    out = flash_attention(q, k, v, kv_map=kv_map, **kw)
    lse = flash_attention_lse_plain(q, k, kv_map=kv_map, **kw)
    _same(_forward(mq, mk, mv, kv_map=kv_map.to("meta"), with_lse=True,
                   **kw), (out, lse))
    pairs = int(attention_mask(T, S, causal=True, window=5,
                               q_offset=4).sum())
    assert meta.visible_pairs(T, S, causal=True, window=5, q_offset=4) \
        == pairs
    assert meta.FLOPS["flash_attention"] == 4.0 * B * H * D * pairs
    _same(flash_attention_bwd(mq, mk, mv, out.to("meta"), lse.to("meta"),
                              mdo, kv_map=kv_map.to("meta"), **kw),
          flash_attention_bwd(q, k, v, out, lse, do, kv_map=kv_map, **kw))
    assert meta.FLOPS["flash_attention_bwd"] == 2.5 * 4.0 * B * H * D * pairs
    lengths = torch.tensor([3, 12])
    for partial in (False, True):
        _same(decode_attention(mq[:, 0], mk, mv, lengths.to("meta"),
                               kv_map=kv_map.to("meta"), partial=partial),
              decode_attention(q[:, 0], k, v, lengths, kv_map=kv_map,
                               partial=partial))
    assert meta.FLOPS["decode_attention"] == 2 * 4.0 * H * D * B * S
    o, lse2 = decode_attention(q[:, 0].float(), k.float(), v.float(),
                               lengths, kv_map=kv_map, partial=True)
    parts = (torch.stack([o.reshape(-1, D)] * 3),
             torch.stack([lse2.reshape(-1)] * 3))
    _same(attn_merge(*(t.to("meta") for t in parts), bf),
          attn_merge(*parts, bf))
    Bz, Ts, Hs, hd, N = 1, 20, 2, 8, 16
    cpu, mt = _both((Bz, Ts, Hs, hd), (Bz, Ts, N), (Bz, Ts, N), (Bz, Ts, Hs),
                    (Hs,), (Hs,), (Bz, Hs, hd, N), (Bz, Ts, Hs, hd),
                    (Bz, Hs, hd, N))
    x, Bm, Cm, dt, A, Dd, s0, dy, dsf = cpu
    mx, mB, mC, mdt, mA, mD, ms0, mdy, mdsf = mt
    _same(ssd_chunked(mx, mB, mC, mdt, mA, mD, ms0),
          ssd_chunked(x, Bm, Cm, dt, A, Dd, s0))
    assert meta.FLOPS["ssd_chunked"] == ssd_cost(Bz, Ts, Hs, hd, N)[0]
    _same(ssd_chunked_bwd(mx, mB, mC, mdt, mA, mD, ms0, mdy, mdsf),
          ssd_chunked_bwd(x, Bm, Cm, dt, A, Dd, s0, dy, dsf))
    assert meta.FLOPS["ssd_chunked_bwd"] == ssd_bwd_cost(Bz, Ts, Hs, hd,
                                                         N)[0]
    cpu, mt = _both((2, 70, 16), (2, 70, 16), (2, 16), (2, 70, 16), (2, 16))
    a, xr, h0, dh, dhf = cpu
    ma, mxr, mh0, mdh, mdhf = mt
    h, _ = rglru_scan(a, xr, h0)
    _same(rglru_scan(ma, mxr, mh0), rglru_scan(a, xr, h0))
    assert meta.FLOPS["rglru_scan"] == rglru_cost(2, 70, 16, True)[0]
    _same(rglru_scan_bwd(ma, h.to("meta"), mh0, mdh, mdhf),
          rglru_scan_bwd(a, h, h0, dh, dhf))
    assert meta.FLOPS["rglru_scan_bwd"] == rglru_bwd_cost(2, 70, 16, True,
                                                          True)[0]
    assert [k.launches for k in LAUNCHES] == launches
