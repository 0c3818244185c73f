"""Smoke run of the PyTorch port on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before a result is printed:
  1. environment — the card's name and power limit, then the build of every
     CUDA kernel from ``src/repro_torch/csrc`` (one nvcc each, in parallel);
  2. kernels — each Hopper kernel against its plain PyTorch version on the
     card (both SSD paths, the in-place decode, ``rglru_scan`` eagerly and
     after CUDA-graph replays), with its time, the plain version's, one
     PyTorch library call's where one computes the same function
     (``scaled_dot_product_attention`` for attention, on K/V expanded to
     the query heads, timed here as a yardstick only; none for the SSD
     scan and the RG-LRU recurrence) and the bound (the larger of the flop
     time at the peak of the units the kernel runs on and the byte time at
     3.35 TB/s, counting the stored KV heads; the SSD dual form counts its
     products three times, 3xTF32, at the TF32 tensor-core peak). The
     attention kernels take the stored KV heads and the query-head ->
     KV-head map: 16 heads over 16 (deepseek-moe-16b's MHA at head dim
     128 among them), smollm's 16 over 5, recurrentgemma's 16 over 1,
     starcoder2-3b's 32 over 2, qwen1.5-32b's 48 over 40 at S = 32768 with
     int8 K/V and bf16 K/V, qwen2-vl-7b's 32 over 4 (1v, 2v), and
     seamless-m4t-medium's encoder and cross-attention over 64 frames
     without a mask (1e, 1x) and its cross-attention at decode (2x).
     Times are device times: ``REPS`` calls captured in one CUDA graph and
     replayed, so the host's launch cost is left out; the eager time per
     call (host included) is printed beside. The attention backward
     (``flash_attention_bwd``) is held to its plain version with the
     forward's row log-sum-exp at full-width smollm-360m's training shape
     (1g-bwd), starcoder2-3b's 32 over 2, recurrentgemma-9b's window at
     head dim 256, seamless's unmasked cross-attention and one float32
     case, each called twice and required bitwise equal, with SDPA's
     backward as its yardstick. The scans' backward kernels
     (``ssd_chunked_bwd``, ``rglru_scan_bwd``) are held to their plain
     versions, every gradient within 1e-4 of its own largest value, at
     the per-layer training shapes of 5m (3bwd) and 5r (4bwd), and with an
     initial state and a final state's adjoint (a ragged chunk, one short
     chunk; 4bwd also after CUDA-graph replays), each called twice and
     required bitwise equal;
  3. serve — behind ``DisaggServer``, random weights from seed 0, bf16:
     full-width smollm-360m on 16 requests (flash and decode attention),
     full-width mamba2-1.3b on an agent-style stream whose follow-ups
     resume snapshots (the SSD scan), then full-width recurrentgemma-9b
     on an agent stream of ~2.1k-token prompts past its 2048 window (the
     RG-LRU scan and both attention kernels at head dim 256 with the
     window), then full-width full-depth deepseek-moe-16b on 3a's stream
     (routed and shared experts beside both attention kernels at head dim
     128); each path's launch counters are zeroed just before its run
     and read just after; 3a prints the device time of ``index_select``
     (no K/V expansion is left, only the embedding lookup), 3b that of
     each SSD path (dual form, recurrence) and of the copies left, 3c the
     share of device time of each attention kernel and of ``rglru_scan``,
     3d the share of the GEMMs, the sort, the index kernels, each attention
     kernel and the MoE paths, the host synchronisations of a prefill and
     the decode-time weight gather alone; then full-width full-depth
     minitron-8b (3e) and starcoder2-3b (3f) on 3a's stream; 3g decodes
     full-width qwen1.5-32b at depth 16 for 8 sequences of ~32k tokens
     from an int8 KV cache (42.9 GB; in bf16 it would not fit), read by
     the decode kernel as codes, timed against the bf16 step at the batch
     that fits and held to the JAX model's int8-vs-bf16 criterion; 3h
     serves deepseek-v3 at full width cut to depth 4 (MLA over paged
     latents, 256 routed experts top-8; the MLA and MoE spans' device
     shares, peak memory, the smallest top-8/top-9 routing margin), 3i
     full-width full-depth qwen2-vl-7b on 3a's stream at 100 requests/s and
     one prefill from input embeddings, 3j full-width full-depth
     seamless-m4t-medium on an agent stream with 64 source frames a request
     (a snapshot resumed; flash launches by mask, decode launches);
  4. whole model — each model in float32 through the kernels on the card
     and through the plain versions on the CPU: prefill of a prompt (256
     tokens; 2112 for recurrentgemma-9b, cut to depth 5; deepseek-moe-16b
     cut to depth 4; minitron-8b and qwen1.5-32b to 2, starcoder2-3b to 4;
     deepseek-v3 to depth 2 with its experts cut out, qwen2-vl-7b to 2 from
     input embeddings, seamless to 2 + 2 layers with 64 source frames) and
     4 decode steps on the caches admitted as ``DecodeBatch.add`` admits
     them (for qwen1.5-32b int8 caches on both sides, the codes that
     differ counted), logits compared; 4t: the loss and every parameter's
     gradient of full-width smollm-360m at depth 2, mamba2-1.3b at depth 2
     and recurrentgemma-9b at depth 3 (one (rec, rec, attn) unit),
     float32, card vs CPU, with each forward and backward kernel's
     launches;
  5. train — ``repro_torch.launch.train.run`` on full-width full-depth
     smollm-360m in bf16 (B=8 x 1024 tokens, AdamW, lr 1e-3, warmup 10,
     seed 0): 6 steps with a checkpoint at 3, a run resumed from it held
     bitwise to the straight run, 20 steps over one batch whose loss must
     fall by more than 1.0, then a warm step timed and one profiled (ms a
     step, tokens a second, peak memory, idle share, the device shares of
     the attention kernels, the GEMMs and the optimizer); the backward
     kernel's launches are this run's; 5s: full-width full-depth
     starcoder2-3b (30 layers, 32 query heads over 2 KV heads, head dim
     128) through the same launcher, B=2 x 1024: 3 steps with finite
     losses and 30 launches of each attention kernel a step, then a warm
     step timed and one profiled; 5m: full-width mamba2-1.3b cut to depth
     24 through the launcher's loop (B=4 x 1024): 3 steps with a
     checkpoint at 2, the loop resumed from it and held bitwise to the
     straight run, 24 launches of each SSD kernel a step, a warm step
     timed and one profiled (the shares of the SSD forward and backward); 5r:
     recurrentgemma-9b at full width cut to depth 6 (B=1 x 2112, past the
     window): 3 steps, the launches of both RG-LRU and both attention
     kernels, a warm step timed and one profiled;
  6. mesh — the port sharded over ``torch.distributed``; the card machine
     has one H100 and NCCL takes one rank a device, so the multi-rank
     phases put 2 or 4 ranks (spawned processes, ``launch.mesh.spawn``)
     on the one card over gloo, whose collectives go through host memory
     (their times are not NCCL's); references run here first and free the
     card. 6k: the attention kernels at a rank's heads (smollm's 8 of 16
     query heads over its 5 KV heads, forward with the lse and backward at
     B=4 x 1024, and decode; deepseek-moe's 8 MHA heads at D=128), as
     phase 2's rows; 6.0: a (1, 1) mesh over NCCL at world size 1,
     full-width smollm-360m's bf16 logits and greedy tokens bitwise those
     of no mesh; 6a: full-width full-depth smollm-360m at (1, 2) and
     (2, 2), float32 logits within 1e-3 of one rank's and 8 greedy tokens
     equal, at (2, 2) the loss and every logical gradient at 4t's depth
     and batch, bf16 training at depth 8, B=8 x 1024 (3 steps, a checkpoint at 2,
     step 0's batch's loss lower after them, a warm step timed, each
     rank's peak memory) and the checkpoint resumed at (1, 1) here, its
     step's loss the sharded run's to 1e-3; 6b: full-width deepseek-moe-16b
     with classic EP at (1, 2) and 2D EP at (2, 2), at depth 4 in float32
     held to the one-process emulation of the same EP (``EPEmulation``,
     router choices compared), then at full depth in bf16 the first 4 of
     3a's prompts prefilled and decoded 8 greedy steps (both MoE
     branches), with the pairs dropped, the ``all_to_all`` bytes and each
     rank's peak memory; at (2, 2) the two data rows' copies of the first
     4 prompts, served again with the EP sums in rank order
     (``OrderedEPSum``), bitwise equal; 6k's rows of the sequence-sharded
     decode: the decode kernel's partial mode on a rank's slots (2ss:
     smollm's 16 over 5 cut into 2 slices of 512, the merged partials held
     to row 2g's single call; 2q8s: qwen1.5-32b's int8 48 over 40 on one
     rank's 16384 slots) and the merge kernel (``attn_merge``) of 2 and 4
     ranks, at D = 512 too; 6c: ``kv_seq_shard`` at (1, 2), qwen1.5-32b at
     full width (float32 depth 2 held to one rank within 1e-3, bf16 depth
     8 over a B=8 x 32768 int8 cache split by slots held to one rank on
     the same codes, a warm step, each rank's peak memory and bytes sent)
     and deepseek-v3 with TP of MLA (float32 depth 2 with and without the
     flag, the loss and every gradient within 1e-3; bf16 depth 4 with its
     MoE layer under EP, the two decodes held to each other); 6z: ZeRO-3
     (the JAX package's training layout), smollm-360m at depth 2 in
     float32 at (2, 1) and (2, 2) with zero3 against one rank (the loss,
     the gradient norm and every parameter after a step within 1e-3), a
     zero3 run at (2, 1) resumed from a checkpoint bitwise equal to the
     straight run, and full-width full-depth starcoder2-3b in bf16 at
     (2, 1) with zero3 and remat (one step: its time, each rank's peak
     and resident state, beside the dry run's estimate with and without
     zero3); 6m: mamba2-1.3b at depth 2 in float32 on a model axis of 2,
     logits, greedy tokens, the loss and every gradient held to one rank,
     the SSD kernels launched on each rank; 6k's rows at 6r's per-rank
     shapes (4r: ``rglru_scan`` over a rank's 2048 channels; 1br: the
     windowed flash kernel at 8 query heads over 1; 2bs: the decode
     kernel's partial mode on 1024 of the ring's 2048 slots; 2xs: the
     cross-attention decode's partial mode on 32 of 64 source positions;
     merge-rg: ``attn_merge`` at D=256); 6r: tensor parallelism of RG-LRU
     and of the encoder-decoder at (1, 2) in float32, recurrentgemma-9b at
     full width cut to one (rec, rec, attn) unit over 2 prompts of 2112
     tokens and seamless-m4t-medium at full width and depth over 64 source
     frames, each without and with ``kv_seq_shard`` (the ring split 1024 /
     1024, the cross K/V 32 / 32): logits within 1e-3 of one rank and the
     greedy tokens equal, the loss and every logical gradient within 1e-3,
     each rank's launches, peak memory and bytes sent a step. Any rank's
     failure fails the phase;
  7. the dry run against the card — ``launch.dryrun``'s estimate of a
     rank's peak memory (its inputs and the most its step holds beyond
     them, on the meta device) beside the card's: phase 5's cell and
     6z's starcoder2-3b rank;
  8. the modeled clock — the server's ``StageProfile`` on the ``H100``
     profile against the card: 3a, 3e, 3f and 3i time
     ``ServingEngine.prefill`` of 4 x 1024 random tokens on their
     full-depth models (warm, median of 3), and phase 8 prints each one's
     measured share of peak (the modeled FLOPs over 989 TFLOP/s times
     that time, required in (0, 1]) and the modeled time at ``H100.mfu``
     beside the measured; each decode row of phase 2 on the cost model
     (``decode_attention_cost`` at ``hbm_bw * hbm_eff``) beside its graph
     time, with the split-KV partials' share of the kernel's traffic
     (``decode_attention_traffic``); 3g's int8 and bf16 steps beside
     ``decode_step_time`` and ``decode_step_roofline``.
``python3 chip_smoke.py --mesh-only`` runs phases 1 and 6k-6c alone and
prints no result lines.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, SXM
HBM_BW = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # as tests/test_kernels.py


def log(*a):
    print(*a, flush=True)


REPS = 20


def time_ms(fn, reps=REPS):
    """Mean time of one eager call, by CUDA events over ``reps`` calls: the
    device time, or the host's issue time where that is longer."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=REPS):
    """Mean device time of one call: ``reps`` calls captured in one CUDA
    graph and replayed, timed by CUDA events. The host's launch cost is not
    in it; the inputs stay in L2 across calls, as they are fresh from the
    projections in the real caller."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= tol + tol * want.float().abs()))
    log(f"  {name}: max_abs_err={err.max().item():.3e} tol={tol:g} "
        f"(atol=rtol) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


def check_rows(name, got, want, rel):
    """Each sequence's output (``[B, H, D]``) held to ``rel`` of its own
    largest value; prints each row's RMS, largest value, error and limit."""
    want, got = want.float(), got.float()
    err = (got - want).abs().amax(dim=(1, 2))
    top = want.abs().amax(dim=(1, 2))
    rms = want.pow(2).mean(dim=(1, 2)).sqrt()
    ok = bool(torch.all(err <= rel * top))
    log(f"  {name}: max_abs_err={err.max().item():.3e}, per row at most "
        f"{rel:g} of its largest value {'ok' if ok else 'FAIL'}")
    for b in range(want.shape[0]):
        log(f"    row {b}: rms {rms[b].item():.3e} max {top[b].item():.3e} "
            f"err {err[b].item():.3e} limit {rel * top[b].item():.3e}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


def check_rel(name, got, want, rel):
    """``got`` within ``rel`` of ``want``'s own largest value (a gradient
    against the plain version's); returns the largest error."""
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    ok = err <= rel * top
    log(f"  {name}: max_abs_err={err:.3e}, largest value {top:.3e}, limit "
        f"{rel:g} of it {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def bound_ms(flops, nbytes, dtype, peak=None):
    """The larger of the operations at ``peak`` (default: the dtype's) and
    the bytes at the HBM rate, in ms, and which of the two it is."""
    t_f, t_b = flops / (peak or PEAK_FLOPS[dtype]), nbytes / HBM_BW
    return max(t_f, t_b) * 1e3, ("operations" if t_f >= t_b else "bytes")


# ------------------------------------------------------------------ phase 2
#: starcoder2-3b's query-head -> KV-head map: min(h // 12, 1) over 32 heads
STARCODER2_MAP = [min(h // 12, 1) for h in range(32)]
#: qwen2-vl-7b's: 28 heads padded to 32 over 4, min(h // 7, 3)
QWEN2VL_MAP = [min(h // 7, 3) for h in range(32)]
#: seamless-m4t-medium's encoder frames in 3j (``src_len_for(256)``)
SEAMLESS_SRC = 64
#: qwen1.5-32b's decode cells: 8 sequences of a 32768-slot cache
QWEN_S = 32768
QWEN_LENGTHS = [1, QWEN_S, QWEN_S - 1, QWEN_S - 24, 17, 20037, QWEN_S // 2 + 1,
                QWEN_S - 100]


def map_list(H, kv_heads, kv_map=None):
    """``kv_map`` (a list), else the query-head -> KV-head map of
    ``kv_heads`` stored heads as Python ints (None when every query head
    has its own): one head for MQA, else smollm-360m's ``min(h // rep,
    kv_heads - 1)`` with rep = 3 over 5 heads, whose 16th (padded) head
    joins the last group."""
    if kv_map is not None:
        return list(kv_map)
    if kv_heads == H:
        return None
    rep = max(1, (H - 1) // kv_heads) if kv_heads > 1 else H
    return [min(h // rep, kv_heads - 1) for h in range(H)]


def kv_map_of(H, kv_heads):
    """``map_list``'s map as the int32 tensor on the card the kernels
    take."""
    return map_tensor(H, kv_heads, None)


def expanded(x, kv_map):
    """K/V at the query heads for the SDPA yardstick, as the rows before
    the map were timed: a stride-0 view of one KV head, the heads copied
    through the map else."""
    from repro_torch.kernels.attn_split import expand_kv
    if x.shape[2] == 1 and kv_map is not None:
        return x.expand(-1, -1, kv_map.numel(), -1)
    return expand_kv(x, kv_map)


def map_tensor(H, kv_heads, kv_map):
    """``map_list(H, kv_heads, kv_map)`` as the int32 tensor on the card
    the kernels take (None for none)."""
    m = map_list(H, kv_heads, kv_map)
    return None if m is None else torch.tensor(m, dtype=torch.int32,
                                               device="cuda")


def flash_case(name, dtype, T, S, D, *, q_offset=0, window=0, causal=True,
               B=1, H=16, kv_heads=None, kv_map=None):
    """K/V hold ``kv_heads`` (default ``H``) stored heads, read through the
    map as the model passes them (``kv_map``, a list, or ``kv_map_of``'s)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    Hk = kv_heads or H
    g = torch.Generator(device="cuda").manual_seed(T * 7 + S + D)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, Hk, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, window=window,
              kv_map=map_tensor(H, Hk, kv_map))
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check(f"flash_attention[{name},{str(dtype)[6:]}]", got, want,
                TOL[dtype])
    qp = torch.arange(T, device="cuda")[:, None] + q_offset
    kp = torch.arange(S, device="cuda")[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device="cuda")
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    pairs = int(mask.sum())               # (query, key) pairs this data needs
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * B * T * H * D + 2 * B * S * Hk * D) * q.element_size()
    qt = q.transpose(1, 2)
    kt, vt = (expanded(x, kw["kv_map"]).transpose(1, 2) for x in (k, v))
    if causal and not window and q_offset == 0 and T == S:
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    else:
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    return _timed(f"flash_attention[{name},{str(dtype)[6:]}]",
                  lambda: flash_attention(q, k, v, **kw),
                  lambda: flash_attention_plain(q, k, v, **kw), lib,
                  flops, nbytes, dtype, err)


#: the forward's row log-sum-exp (base e) against the plain one from the
#: same inputs: float32 sums of the same products in another order, and the
#: kernel's exp2/log2 approximations, ~1e-6 relative at the phase-2 shapes
LSE_TOL = 1e-4


def bwd_case(name, B, T, S, D, *, H=16, kv_map=None, kv_heads=None,
             causal=True, window=0, q_offset=0, dtype=torch.bfloat16):
    """The attention backward kernel against ``flash_attention_bwd_plain``
    on the same inputs (the forward kernel's output and lse, checked first
    against the plain lse), called twice and required bitwise equal; its
    device time, the plain version's, the bound (2.5x the forward's flops
    over the visible pairs at the dtype's peak, or the bytes of q, k, v, o,
    dO, dq, dk, dv, lse and delta) and, as a yardstick, the backward of
    ``scaled_dot_product_attention`` on K/V expanded to the query heads
    (its forward and backward less its forward, eager)."""
    from repro_torch.kernels.flash_attention import (
        _forward, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_lse_plain)
    from repro_torch.kernels.ref import attention_mask
    Hk = kv_heads or H
    g = torch.Generator(device="cuda").manual_seed(T * 3 + S + D)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, Hk, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    dout = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    host = map_list(H, Hk, kv_map)
    m = map_tensor(H, Hk, kv_map)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=None,
              kv_map=m)
    label = (f"flash_attention_bwd[{name} B={B} T={T} S={S} D={D} "
             f"{H}->{Hk},{str(dtype)[6:]}]")
    out, lse = _forward(q, k, v, with_lse=True, **kw)
    want_lse = flash_attention_lse_plain(q, k, **kw)
    torch.cuda.synchronize()
    check(f"{label} lse", lse, want_lse, LSE_TOL)
    got = flash_attention_bwd(q, k, v, out, lse, dout, kv_map_host=host,
                              **kw)
    n_split = flash_attention_bwd.n_split        # the split it launched
    if dtype is torch.bfloat16:
        log(f"  {label}: dK/dV grid {B * Hk * -(-S // 64) * n_split} blocks "
            f"({B} x {Hk} KV heads x {-(-S // 64)} key tiles x {n_split} "
            f"splits), dQ grid {B * H * -(-T // 64)}")
    else:
        log(f"  {label}: float32 kernels, dK/dV grid "
            f"{B * Hk * -(-S // 32)} blocks (no split)")
    again = flash_attention_bwd(q, k, v, out, lse, dout, kv_map_host=host,
                                **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    err = max(check(f"{label} {n}", a, b, TOL[dtype])
              for n, a, b in zip(("dq", "dk", "dv"), got, want))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  {label}: two calls bitwise equal: {bitwise}")
    if not bitwise:
        raise SystemExit(f"{label}: two calls differ")
    mask = attention_mask(T, S, causal=causal, window=window,
                          q_offset=q_offset, device="cuda")
    pairs = int(mask.sum())              # (query, key) pairs this data needs
    flops = 2.5 * 4.0 * B * H * D * pairs
    es = q.element_size()
    nbytes = (4 * B * T * H * D + 4 * B * S * Hk * D) * es + 2 * B * H * T * 4
    qt, dot = (x.transpose(1, 2) for x in (q, dout))
    kt, vt = (expanded(x, m).transpose(1, 2) for x in (k, v))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_kw = (dict(is_causal=True) if causal and not window and
               q_offset == 0 and T == S else
               dict(attn_mask=mask) if causal or window else {})

    def sdpa_fwd():
        return torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                                **sdpa_kw)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), leaves, dot)
    lib_ms = max(0.0, time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd))
    r = _timed(label, lambda: flash_attention_bwd(q, k, v, out, lse, dout,
                                                  kv_map_host=host, **kw),
               lambda: flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                 **kw),
               None, flops, nbytes, dtype, err, plain_reps=2)
    r["library_ms"] = lib_ms
    log(f"    {label}: SDPA backward (fwd+bwd less fwd, eager) "
        f"{lib_ms:.4f} ms")
    return r, (q, k, v, kw)


def row2_lengths(S):
    """Row 2's lengths over ``S`` slots: one key, all, none, and off the
    64-key tile."""
    return [1, S, 0, 17, 128, 129, S // 2, S - 24]


def decode_case(dtype, B=8, H=16, D=64, S=1024, kv_heads=None, *,
                kv_map=None, lengths=None, int8=False, label="",
                plain_reps=REPS, row_rel=None):
    """Decode at ``B`` sequences over ``S`` slots of ``kv_heads`` stored
    heads (``kv_map`` as in ``flash_case``); ``lengths`` default to row 2's.
    With ``int8`` the K/V are the model's int8 codes of N(0, 1) values
    (``blocks._kv_store``): the kernel reads the codes, the plain version
    dequantises them first, and the SDPA yardstick runs on K/V dequantised
    and expanded beforehand, untimed; the bound counts one byte a K/V
    element. With ``row_rel`` each sequence's output is held to that share
    of its own largest value (``check_rows``) instead of ``TOL``."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.models.blocks import _KV_QSCALE, _kv_load, _kv_store
    Hk = kv_heads or H
    g = torch.Generator(device="cuda").manual_seed(S + D)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, Hk, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    kv_scale = None
    if int8:
        k, v = (_kv_store(x, torch.int8) for x in (k, v))
        kv_scale = 1.0 / _KV_QSCALE
    kv_map = map_tensor(H, Hk, kv_map)
    lengths = torch.tensor(lengths or row2_lengths(S), dtype=torch.int32,
                           device="cuda")[:B]
    kw = dict(kv_map=kv_map, kv_scale=kv_scale)
    got = decode_attention(q, k, v, lengths, **kw)
    want = decode_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    name = (f"decode_attention[{label + ' ' if label else ''}B={B},S={S},"
            f"D={D},H={H},Hk={Hk},{str(dtype)[6:]}"
            f"{', K/V int8' if int8 else ''}]")
    err = (check(name, got, want, TOL[dtype]) if row_rel is None
           else check_rows(name, got, want, row_rel))
    keys = int(lengths.sum())
    flops = 4.0 * H * D * keys
    nbytes = (2 * keys * Hk * D * k.element_size()
              + 2 * B * H * D * q.element_size() + 4 * B)
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None])
    qt = q[:, :, None]
    kt, vt = (expanded(_kv_load(x, dtype), kv_map).transpose(1, 2)
              for x in (k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None])
    return _timed(name,
                  lambda: decode_attention(q, k, v, lengths, **kw),
                  lambda: decode_attention_plain(q, k, v, lengths, **kw), lib,
                  flops, nbytes, dtype, err, plain_reps=plain_reps)


def _timed(name, kernel, plain, lib, flops, nbytes, dtype, err,
           plain_reps=REPS, peak=None):
    """Device times (graph replay) of the kernel, its plain version (over
    ``plain_reps`` calls in its graph) and the library call (None where
    there is none), with the eager time per kernel call beside; the bound
    counts ``flops`` at ``peak`` (default: the dtype's)."""
    ms, plain_ms = graph_ms(kernel), graph_ms(plain, plain_reps)
    lib_ms = graph_ms(lib) if lib is not None else None
    eager = time_ms(kernel)
    b_ms, b_by = bound_ms(flops, nbytes, dtype, peak)
    lib_txt = f"{lib_ms:.4f} ms" if lib is not None else "none"
    log(f"    {name}: kernel {ms:.4f} ms (eager call {eager:.4f} ms) | "
        f"plain {plain_ms:.4f} ms ({plain_reps} calls a graph) | library "
        f"{lib_txt} | bound {b_ms:.5f} ms "
        f"({b_by}) | {flops:.3e} flop {nbytes:.3e} B")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


SSD_TOL = 1e-4      # as tests/test_kernels.py: float32, the recurrence vs
#                     the chunked dual form sum in different orders


def ssd_inputs(Bz, T, *, H=64, hd=64, N=128, with_init=True, seed=0):
    """float32 inputs at mamba2-1.3b's widths, scaled as the JAX kernel
    tests scale them (dt in [0.001, 0.1], A in [-2, -0.5])."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = rand(Bz, T, H, hd)
    B, C = rand(Bz, T, N) * 0.5, rand(Bz, T, N) * 0.5
    dt = torch.rand(Bz, T, H, generator=g, device="cuda") * 0.099 + 0.001
    A = -(torch.rand(H, generator=g, device="cuda") * 1.5 + 0.5)
    D = rand(H)
    s0 = rand(Bz, H, hd, N) if with_init else None
    return x, B, C, dt, A, D, s0


TF32_PEAK = 495e12   # dense TF32 tensor cores, SXM


def ssd_kernel_work(Bz, T, H, hd, N):
    """(operations, peak rate) of the units the kernel ``ssd_plan`` picks
    runs on. The recurrence: ``ssd_cost``'s 4*Bz*T*H*hd*N flops on the
    float32 CUDA cores. The dual form: its four products over the steps
    this T has (G = C B^T once per sequence and chunk, as the heads share
    B and C; G o L and x over the causal pairs; C s^T and the state update
    over every step), three TF32 products each (3xTF32) on the tensor
    cores."""
    from repro_torch.kernels.ssd_scan import ssd_cost, ssd_plan
    plan = ssd_plan(Bz, T, H, hd, N)
    if plan.path == "recurrence":
        return ssd_cost(Bz, T, H, hd, N)[0], PEAK_FLOPS[torch.float32]
    pairs = _causal_pairs(T, plan.chunk)
    products = (2.0 * Bz * pairs * N + 2.0 * Bz * H * pairs * hd
                + 2 * 2.0 * Bz * T * H * hd * N)
    return 3 * products, TF32_PEAK


def _causal_pairs(T, Q):
    """(t, s) pairs with s <= t inside chunks of Q steps over T steps."""
    return sum(n * (n + 1) // 2 for n in
               (min(Q, T - t0) for t0 in range(0, T, Q)))


def ssd_bwd_kernel_work(Bz, T, H, hd, N):
    """(operations, peak rate) of the gradient's products, counted as
    ``ssd_kernel_work`` counts the forward's: three TF32 products each
    (3xTF32) on the tensor cores, the card's rate for float32-accurate
    products, whichever units the kernel runs them on. Over the causal
    pairs of each chunk: G = C B^T, dC's dG B and dB's dG^T C once per
    sequence (the heads share B and C), dx's M^T dy and dM = dy x^T per
    head. Over every step, per head: B ds^T (dx), dy s_in (dC and the
    decays' term), x ds (dB and dw) and the adjoint carried to the chunk's
    entry (dy^T C). The chunk-entry states are the forward's: the kernel
    recomputes them, which is not counted."""
    from repro_torch.kernels.ssd_scan import SSD_BWD_CHUNK
    pairs = _causal_pairs(T, SSD_BWD_CHUNK)
    products = (3 * 2.0 * Bz * pairs * N + 2 * 2.0 * Bz * H * pairs * hd
                + 4 * 2.0 * Bz * T * H * hd * N)
    return 3 * products, TF32_PEAK


def ssd_case(name, Bz, T, *, with_init=True, in_place=False):
    """``in_place``: the final state written over the initial one, as
    decode updates its cache."""
    from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_chunked_plain,
                                              ssd_cost, ssd_plan)
    args = ssd_inputs(Bz, T, with_init=with_init, seed=Bz * 1000 + T)
    x, N = args[0], args[1].shape[-1]
    H, hd = x.shape[2], x.shape[3]
    yp, sp = ssd_chunked_plain(*args)
    if in_place:
        cache = args[6].clone()
        call = lambda: ssd_chunked(*args[:6], cache, out_state=cache)
    else:
        call = lambda: ssd_chunked(*args)
    y, s = call()
    torch.cuda.synchronize()
    path = ssd_plan(Bz, T, H, hd, N).path
    label = f"ssd_chunked[{name}, {path}]"
    err = max(check(f"{label} y", y, yp, SSD_TOL),
              check(f"{label} state", s, sp, SSD_TOL))
    if in_place:
        assert s is cache, "out_state was not written in place"
    _, nbytes = ssd_cost(Bz, T, H, hd, N, with_init=with_init)
    ops, peak = ssd_kernel_work(Bz, T, H, hd, N)
    # no single PyTorch call computes the SSD scan: library_ms is null
    return _timed(label, call, lambda: ssd_chunked_plain(*args), None, ops,
                  nbytes, torch.float32, err, peak=peak)


def ssd_chain_case(T=256):
    """Two calls of T/2, the second resuming the first's state, equal one
    call of T (what a suffix prefill over a snapshot relies on)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked
    x, B, C, dt, A, D, _ = ssd_inputs(1, T, with_init=False, seed=7)
    y, s = ssd_chunked(x, B, C, dt, A, D)
    h = T // 2
    y1, s1 = ssd_chunked(x[:, :h], B[:, :h], C[:, :h], dt[:, :h], A, D)
    y2, s2 = ssd_chunked(x[:, h:], B[:, h:], C[:, h:], dt[:, h:], A, D, s1)
    torch.cuda.synchronize()
    check(f"ssd_chunked[chain 2x{h} = {T}] y", torch.cat([y1, y2], 1), y,
          SSD_TOL)
    check(f"ssd_chunked[chain 2x{h} = {T}] state", s2, s, SSD_TOL)


RGLRU_TOL = 1e-4    # as tests/test_kernels.py: float32, the kernel's fused
#                     multiply-add vs the plain version's multiply and add


def rglru_inputs(B, T, W=4096, with_init=True, seed=0):
    """float32 inputs at recurrentgemma-9b's width, a in [0.7, 0.999] and x,
    the state N(0, 1), as the JAX kernel tests draw them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(B, T, W, generator=g, device="cuda") * 0.299 + 0.7
    x = torch.randn(B, T, W, generator=g, device="cuda")
    s0 = torch.randn(B, W, generator=g, device="cuda") if with_init else None
    return a, x, s0


def replay_check(name, fn, want, tol, replays=3):
    """``fn`` captured once in a CUDA graph and replayed ``replays`` times,
    its outputs poisoned with NaN before each replay; the last replay's
    outputs are held against ``want``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(replays):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
    torch.cuda.synchronize()
    return max(check(f"{name} graph replay {replays}, {i}", o, w, tol)
               for i, (o, w) in enumerate(zip(out, want)))


def rglru_case(name, B, T, W=4096, *, with_init=True):
    from repro_torch.kernels.rglru import (rglru_cost, rglru_scan,
                                           rglru_scan_plain)
    args = rglru_inputs(B, T, W, with_init, seed=B * 1000 + T)
    h, s = rglru_scan(*args)
    hp, sp = rglru_scan_plain(*args)
    torch.cuda.synchronize()
    err = max(check(f"rglru_scan[{name}] h", h, hp, RGLRU_TOL),
              check(f"rglru_scan[{name}] state", s, sp, RGLRU_TOL))
    # the flags of the look-back are cleared by a memset inside each call:
    # a replayed graph must start from clear flags too
    err = max(err, replay_check(f"rglru_scan[{name}]",
                                lambda: rglru_scan(*args), (hp, sp),
                                RGLRU_TOL))
    flops, nbytes = rglru_cost(B, T, W, with_init)
    # the plain version is a Python loop of T steps, ~2 kernels a step: a
    # graph of 20 calls at T = 2112 would hold ~85k nodes, so long cases
    # time it over 2 calls in the graph; no single PyTorch call computes a
    # linear recurrence, so library_ms is null
    return _timed(f"rglru_scan[{name}]", lambda: rglru_scan(*args),
                  lambda: rglru_scan_plain(*args), None, flops, nbytes,
                  torch.float32, err, plain_reps=REPS if T <= 64 else 2)


def rglru_chain_case(T=2112):
    """Two calls of T/2, the second resuming the first's state, equal one
    call of T (what a suffix prefill over a snapshot relies on)."""
    from repro_torch.kernels.rglru import rglru_scan
    a, x, _ = rglru_inputs(1, T, with_init=False, seed=7)
    h, s = rglru_scan(a, x)
    m = T // 2
    h1, s1 = rglru_scan(a[:, :m], x[:, :m])
    h2, s2 = rglru_scan(a[:, m:], x[:, m:], s1)
    torch.cuda.synchronize()
    check(f"rglru_scan[chain 2x{m} = {T}] h", torch.cat([h1, h2], 1), h,
          RGLRU_TOL)
    check(f"rglru_scan[chain 2x{m} = {T}] state", s2, s, RGLRU_TOL)


SSD_GRADS = ("dx", "dB", "dC", "ddt", "dA", "dD", "d init_state")
RGLRU_GRADS = ("da", "dx", "d init_state")


def _bitwise(label, first, again):
    same = all(torch.equal(a, b) for a, b in zip(first, again)
               if a is not None)
    log(f"  {label}: two calls bitwise equal: {same}")
    if not same:
        raise SystemExit(f"{label}: two calls of the kernel differ")


def ssd_bwd_case(name, Bz, T, *, with_state):
    """The SSD backward (``ssd_chunked_bwd``) against its plain version at
    mamba2-1.3b's widths: every gradient within SSD_TOL of its own largest
    value, two calls bitwise equal, then timed. ``with_state``: an initial
    state and a final state's adjoint (training has neither)."""
    from repro_torch.kernels.ssd_scan import (ssd_bwd_cost, ssd_chunked_bwd,
                                              ssd_chunked_bwd_plain)
    x, B, C, dt, A, D, s0 = ssd_inputs(Bz, T, with_init=with_state,
                                       seed=Bz * 1000 + T + 1)
    g = torch.Generator(device="cuda").manual_seed(T + 2)
    dy = torch.randn(x.shape, generator=g, device="cuda")
    Bz, T, H, hd = x.shape
    N = B.shape[-1]
    dsf = (torch.randn(Bz, H, hd, N, generator=g, device="cuda")
           if with_state else None)
    args = (x, B, C, dt, A, D, s0, dy, dsf)
    got = ssd_chunked_bwd(*args)
    again = ssd_chunked_bwd(*args)
    want = ssd_chunked_bwd_plain(*args)
    torch.cuda.synchronize()
    label = f"ssd_chunked_bwd[{name}]"
    err = max(check_rel(f"{label} {n}", a, b, SSD_TOL)
              for n, a, b in zip(SSD_GRADS, got, want) if b is not None)
    _bitwise(label, got, again)
    _, nbytes = ssd_bwd_cost(Bz, T, H, hd, N, with_init=with_state,
                             with_dsf=with_state)
    ops, peak = ssd_bwd_kernel_work(Bz, T, H, hd, N)
    # no single PyTorch call computes the gradient: library_ms is null
    return _timed(label, lambda: ssd_chunked_bwd(*args),
                  lambda: ssd_chunked_bwd_plain(*args), None, ops, nbytes,
                  torch.float32, err, plain_reps=2, peak=peak)


def rglru_bwd_case(name, B, T, W=4096, *, with_state):
    """The RG-LRU backward (``rglru_scan_bwd``) against its plain version at
    recurrentgemma-9b's width: every gradient within RGLRU_TOL of its own
    largest value, two calls bitwise equal, three CUDA-graph replays (its
    flags are cleared by a memset inside each call), then timed."""
    from repro_torch.kernels.rglru import (rglru_bwd_cost, rglru_scan_bwd,
                                           rglru_scan_bwd_plain,
                                           rglru_scan_plain)
    a, x, s0 = rglru_inputs(B, T, W, with_state, seed=B * 1000 + T + 1)
    h, _ = rglru_scan_plain(a, x, s0)
    g = torch.Generator(device="cuda").manual_seed(T + 2)
    dh = torch.randn(B, T, W, generator=g, device="cuda")
    dhf = (torch.randn(B, W, generator=g, device="cuda") if with_state
           else None)
    args = (a, h, s0, dh, dhf)
    got = rglru_scan_bwd(*args)
    again = rglru_scan_bwd(*args)
    want = rglru_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    label = f"rglru_scan_bwd[{name}]"
    err = max(check_rel(f"{label} {n}", a_, b_, RGLRU_TOL)
              for n, a_, b_ in zip(RGLRU_GRADS, got, want) if b_ is not None)
    _bitwise(label, got, again)

    def call():
        return tuple(t for t in rglru_scan_bwd(*args) if t is not None)
    err = max(err, replay_check(label, call,
                                tuple(t for t in want if t is not None),
                                RGLRU_TOL))
    flops, nbytes = rglru_bwd_cost(B, T, W, with_state, with_state)
    # the plain version is a Python loop of T steps: 2 calls a graph
    return _timed(label, lambda: rglru_scan_bwd(*args),
                  lambda: rglru_scan_bwd_plain(*args), None, flops, nbytes,
                  torch.float32, err, plain_reps=2)


def phase_kernels():
    """Returns the main path's cases (the kernels line) and the decode rows
    (their label, dtype, ``decode_case``'s keywords and times) for phase
    8."""
    log("[2] kernels against their plain versions on the card")
    main, decode_rows = {}, []

    def decode_row(row, dtype, **kw):
        r = decode_case(dtype, **kw)
        decode_rows.append((row, dtype, kw, r))
        return r
    for dtype in (torch.bfloat16, torch.float32):
        r = flash_case("prefill T=S=512 D=64", dtype, 512, 512, 64)
        if dtype is torch.bfloat16:
            main["flash_attention"] = r
        flash_case("suffix T=128 S=640 q_offset=512", dtype, 128, 640, 64,
                   q_offset=512)
        for D in (32, 96):
            flash_case(f"D={D} T=S=256", dtype, 256, 256, D)
        flash_case("window=128 T=S=512", dtype, 512, 512, 64, window=128)
        flash_case("non-causal T=200 S=300", dtype, 200, 300, 64,
                   causal=False)
        r = decode_row("2", dtype)
        if dtype is torch.bfloat16:
            main["decode_attention"] = r
        # smollm-360m's real GQA: 16 padded query heads over 5 KV heads
        flash_case("GQA 16->5 T=S=512 D=64", dtype, 512, 512, 64,
                   kv_heads=5)
        decode_row("2g", dtype, kv_heads=5)
        # recurrentgemma-9b's local attention: 16 query heads over one
        # stored KV head, head dim 256, window 2048
        flash_case("D=256 window=2048 T=S=2112 MQA", dtype, 2112, 2112, 256,
                   window=2048, kv_heads=1)
        flash_case("D=256 window=2048 suffix T=32 S=2080 q_offset=2048 MQA",
                   dtype, 32, 2080, 256, q_offset=2048, window=2048,
                   kv_heads=1)
        decode_row("2b", dtype, D=256, S=2048, kv_heads=1)
        # deepseek-moe-16b's attention: 16 query heads over 16 KV heads
        # (MHA), head dim 128; a 256-token prompt, the suffix over a reused
        # 32-token prefix, and the decode step at 8 slots
        flash_case("deepseek-moe-16b D=128 T=S=256 MHA", dtype, 256, 256, 128)
        flash_case("deepseek-moe-16b suffix D=128 T=224 S=256 q_offset=32 "
                   "MHA", dtype, 224, 256, 128, q_offset=32)
        decode_row("2m", dtype, D=128)
        # starcoder2-3b's attention (1s, 2s): 24 heads padded to 32 over 2
        # KV heads in groups of 12 and 20 (the second holds the 8 padded
        # heads), head dim 128
        flash_case("1s starcoder2-3b D=128 T=S=512 32->2", dtype, 512, 512,
                   128, H=32, kv_heads=2, kv_map=STARCODER2_MAP)
        decode_row("2s", dtype, H=32, D=128, kv_heads=2,
                   kv_map=STARCODER2_MAP, label="2s starcoder2-3b")
        # qwen2-vl-7b's attention (1v, 2v): 28 heads padded to 32 over 4 KV
        # heads in groups of 7 (the last serves 11, 4 of them padded no-ops)
        flash_case("1v qwen2-vl-7b D=128 T=S=512 32->4", dtype, 512, 512,
                   128, H=32, kv_heads=4, kv_map=QWEN2VL_MAP)
        decode_row("2v", dtype, H=32, D=128, kv_heads=4, kv_map=QWEN2VL_MAP,
                   label="2v qwen2-vl-7b")
        # seamless-m4t-medium's (1e, 1x, 2x): 16 MHA heads of 64; the
        # encoder over 64 frames, a 256-token prefill's cross-attention over
        # them (both non-causal), and 8 sequences' cross-attention at decode
        # over all 64 (the decode kernel, every length at S)
        flash_case(f"1e seamless encoder D=64 T=S={SEAMLESS_SRC} "
                   "non-causal", dtype, SEAMLESS_SRC, SEAMLESS_SRC, 64,
                   causal=False)
        flash_case(f"1x seamless cross T=256 S={SEAMLESS_SRC} non-causal",
                   dtype, 256, SEAMLESS_SRC, 64, causal=False)
        decode_row("2x", dtype, D=64, S=SEAMLESS_SRC,
                   lengths=[SEAMLESS_SRC] * 8, label="2x seamless cross")
    # qwen1.5-32b's decode step at 32k (2q8, 2q16): 40 MHA heads padded to
    # 48 over the 40 KV heads of an init_cache cache (the map is the
    # identity over 48; the kernel clamps the padded heads to the last),
    # 8 sequences, lengths 1, full and off the 64-key tile; K/V int8 as
    # phase 3g decodes them, and bf16. Over 16k-32k keys of N(0, 1) values
    # an output is ~0.01, so the bf16 cases are held row by row to one bf16
    # ulp of the row's largest value (both sides round a float32 result to
    # bf16), not to TOL's 2e-2; the float32 run of 2q8 holds the split plan
    # and the int8 loads at TOL's 2e-5. The plain version holds the whole
    # cache expanded to 48 heads (~13 GB a call in bf16): 2 calls a graph
    for label, dtype, int8 in (
            ("2q8 qwen1.5-32b", torch.bfloat16, True),
            ("2q16 qwen1.5-32b", torch.bfloat16, False),
            ("2q8 qwen1.5-32b", torch.float32, True)):
        decode_row(label.split()[0], dtype, H=48, D=128, S=QWEN_S,
                   kv_heads=40, kv_map=list(range(48)), lengths=QWEN_LENGTHS,
                   int8=int8, label=label, plain_reps=2,
                   row_rel=2.0 ** -7 if dtype is torch.bfloat16 else None)
    # mamba2-1.3b's serve shapes (H=64, hd=64, N=128), float32 as the model
    # feeds the scan (the conv output is float32)
    main["ssd_chunked"] = ssd_case("prefill Bz=1 T=256", 1, 256,
                                   with_init=False)
    ssd_case("prefill Bz=1 T=256 init_state", 1, 256)
    ssd_case("fresh Bz=1 T=288", 1, 288, with_init=False)
    ssd_case("ragged T=100 init_state", 1, 100)
    # either side of the recurrence / dual-form threshold (32 steps; the
    # suffix is at it)
    ssd_case("suffix T=32 init_state", 1, 32)
    ssd_case("short T=16 init_state", 1, 16)
    ssd_case("past the threshold T=48 init_state", 1, 48)
    ssd_case("decode Bz=8 T=1", 8, 1)
    ssd_case("decode Bz=8 T=1 in place", 8, 1, in_place=True)
    ssd_chain_case()
    # recurrentgemma-9b's serve shapes (W = 4096), float32 as the model
    # feeds the scan
    main["rglru_scan"] = rglru_case("prefill B=1 T=2112", 1, 2112,
                                    with_init=False)
    rglru_case("suffix B=1 T=32 init_state", 1, 32)
    rglru_case("decode B=8 T=1 init_state", 8, 1)
    rglru_case("ragged B=3 T=33 W=100 init_state", 3, 33, 100)
    rglru_chain_case()
    # the scans' backward (3bwd, 4bwd) at the per-layer shapes of phases 5m
    # and 5r (no initial state, no final state's adjoint: training), then
    # with both on a ragged chunk and on one short chunk (T <= 32, where
    # the forward runs its recurrence)
    main["ssd_chunked_bwd"] = ssd_bwd_case(
        f"3bwd mamba2-1.3b Bz={MAMBA_TRAIN_B} T={MAMBA_TRAIN_T}",
        MAMBA_TRAIN_B, MAMBA_TRAIN_T, with_state=False)
    ssd_bwd_case("ragged T=100 init_state", 1, 100, with_state=True)
    ssd_bwd_case("one short chunk T=16 init_state", 1, 16, with_state=True)
    main["rglru_scan_bwd"] = rglru_bwd_case(
        f"4bwd recurrentgemma-9b B={RG_TRAIN_B} T={RG_TRAIN_T}", RG_TRAIN_B,
        RG_TRAIN_T, with_state=False)
    rglru_bwd_case(f"4bwd B={RG_TRAIN_B} T={RG_TRAIN_T} init_state",
                   RG_TRAIN_B, RG_TRAIN_T, with_state=True)
    # the attention backward at the training shapes: 1g-bwd is full-width
    # smollm-360m's train step (B=8, T=1024, 15 heads padded to 16 over 5
    # KV heads, head dim 64); starcoder2-3b's 32 over 2 in groups of 12 and
    # 20 at head dim 128 (the most uneven sum over a KV head's query
    # heads); recurrentgemma-9b's window of 2048 at head dim 256 over one
    # KV head; seamless-m4t-medium's cross-attention without a mask
    r, (q, k, v, kw) = bwd_case("1g-bwd smollm-360m", 8, 1024, 1024, 64,
                                kv_heads=5)
    main["flash_attention_bwd"] = r
    fwd_lse_timing(q, k, v, kw)
    bwd_case("1s-bwd starcoder2-3b", 2, 1024, 1024, 128, H=32, kv_heads=2,
             kv_map=STARCODER2_MAP)
    bwd_case("1r-bwd recurrentgemma-9b window=2048", 1, 2112, 2112, 256,
             kv_heads=1, window=2048)
    bwd_case("1x-bwd seamless cross", 8, 256, SEAMLESS_SRC, 64,
             causal=False)
    bwd_case("1f-bwd float32 smollm-360m", 2, 256, 256, 64, kv_heads=5,
             dtype=torch.float32)
    return main, decode_rows


def fwd_lse_timing(q, k, v, kw):
    """Row 1t: the forward kernel's device time at 1g-bwd's shapes with the
    row log-sum-exp written (the train path) and without it (serving), the
    plain version's (output and lse, 2 calls a graph) and SDPA's forward on
    K/V expanded to the query heads."""
    from repro_torch.kernels.flash_attention import (
        _forward, flash_attention_lse_plain, flash_attention_plain)
    with_lse = graph_ms(lambda: _forward(q, k, v, with_lse=True, **kw))
    without = graph_ms(lambda: _forward(q, k, v, with_lse=False, **kw))
    plain = graph_ms(lambda: (flash_attention_plain(q, k, v, **kw),
                              flash_attention_lse_plain(q, k, **kw)), 2)
    qt = q.transpose(1, 2)
    kt, vt = (expanded(x, kw["kv_map"]).transpose(1, 2) for x in (k, v))
    sdpa = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    log(f"    flash_attention forward at 1g-bwd's shapes: with lse "
        f"{with_lse:.4f} ms, without {without:.4f} ms | plain (output and "
        f"lse) {plain:.4f} ms | library {sdpa:.4f} ms (SDPA forward)")


# ------------------------------------------------------------------ phase 3
def serve_once(model, reqs, capacity):
    """One ``DisaggServer.serve`` over ``reqs`` with ``capacity`` decode
    tokens a slot; returns the results, the prefill / decode calls and the
    phase's wall seconds (each prefill and decode call ends in a device
    synchronise)."""
    from repro_torch.core import make_policy
    from repro_torch.serving import DisaggConfig, DisaggServer

    srv = DisaggServer(model, policy=make_policy("mfs"), cfg=DisaggConfig(
        n_prefill_units=2, decode_slots=8, decode_capacity=capacity))
    wall = {"prefill": 0.0, "decode": 0.0}
    calls = {"prefill": 0, "decode": 0}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        return run
    for eng in srv.engines:
        eng.prefill = timed(eng.prefill, "prefill")
    srv.decoder.step = timed(srv.decoder.step, "decode")
    t0 = time.perf_counter()
    res = srv.serve(reqs, decode_steps=8)
    torch.cuda.synchronize()
    t_phase = time.perf_counter() - t0
    log(f"  phase {t_phase:.3f} s | prefill {wall['prefill']:.3f} s over "
        f"{calls['prefill']} requests | decode {wall['decode']:.3f} s over "
        f"{calls['decode']} steps")
    return res, calls, t_phase


def serve_counted(model, reqs, kernels, capacity=1024, shapes=None):
    """Run 1 of a serve phase: the launch counters of ``kernels`` (their
    wrapper functions) are zeroed just before and read just after. Checks
    the results and returns (launches, results, decode steps). ``shapes``
    names an entry point of ``repro_torch.kernels.ops`` ("ssd", "rglru")
    whose calls are tallied by (batch, T, initial state given) on the way,
    printed as the serve path's launches of each case."""
    from repro_torch.kernels import ops
    vocab = model.cfg.vocab
    log("  run 1 (cold, counted):")
    tally = {}
    if shapes is not None:
        inner = getattr(ops, shapes)

        def counted(first, *a, **kw):
            init = kw.get("init_state", a[-1] if a else None)
            key = (first.shape[0], first.shape[1], init is not None)
            tally[key] = tally.get(key, 0) + 1
            return inner(first, *a, **kw)
        setattr(ops, shapes, counted)
    for k in kernels:
        k.launches = 0
    try:
        res, calls, _ = serve_once(model, reqs, capacity)
    finally:
        if shapes is not None:
            setattr(ops, shapes, inner)
    launches = {k.__name__: k.launches for k in kernels}
    if tally:
        log(f"  {shapes} calls by (batch, T, initial state): " + ", ".join(
            f"{k}: {n}" for k, n in sorted(tally.items())))
    steps = max(len(r.tokens) for r in res) - 1
    log(f"  launches {launches} | prompt tokens "
        f"{sum(len(r.tokens) for r in reqs)} | reused "
        f"{sum(r.reused_tokens for r in res)} | slo "
        f"{sum(r.met_slo for r in res)}/{len(res)}")
    assert len(res) == len(reqs)
    assert all(0 <= r.first_token < vocab for r in res), "first token"
    assert all(0 <= t < vocab for r in res for t in r.tokens)
    assert calls["prefill"] == len(reqs) and steps > 0
    return launches, res, steps


#: one device-side row of a profiled run: a kernel's or a copy's name, its
#: device time in microseconds and its calls (``FunctionEventAvg``'s names)
DeviceRow = collections.namedtuple(
    "DeviceRow", ["key", "self_device_time_total", "count"])


def device_rows(prof, spans=()):
    """What ``prof.key_averages()`` gives of a ``torch.profiler`` run's
    device side, summed straight from ``prof.events()``: key_averages also
    totals every host event's times through its children, ~20 s on a
    serve run's events (3a and 3b on the H100). Returns the ``DeviceRow``
    of each name run on the device with a positive device time, the
    ``spans`` left out, and each span's (a ``record_function`` range on
    the host) [device time of the kernels launched in it, calls]."""
    from torch.autograd import DeviceType
    dev, spanned = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.key not in spans:
            acc = dev.setdefault(e.key, [0.0, 0])
            acc[0] += e.self_device_time_total
        elif e.device_type == DeviceType.CPU and e.key in spans:
            acc = spanned.setdefault(e.key, [0.0, 0])
            acc[0] += e.device_time_total
        else:
            continue
        acc[1] += 1
    return ([DeviceRow(k, t, n) for k, (t, n) in dev.items() if t > 0],
            spanned)


def serve_profiled(model, reqs, capacity=1024, spans=None):
    """Run 2 (warm) and run 3 (warm, under ``torch.profiler``): device busy
    time, the idle share and the top kernels by device time. ``spans`` maps
    a label to (module, function name): in run 3 each such function runs
    inside a ``record_function`` range of that label, and the device time
    of the kernels launched in it is printed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = spans or {}
    log("  run 2 (warm):")
    _, _, warm = serve_once(model, reqs, capacity)
    log("  run 3 (warm, under torch.profiler):")
    inner = {label: getattr(mod, fn) for label, (mod, fn) in spans.items()}

    def spanned(label):
        def run(*a, **kw):
            with record_function(label):
                return inner[label](*a, **kw)
        return run
    for label, (mod, fn) in spans.items():
        setattr(mod, fn, spanned(label))
    # the host's events only where a span needs them: turning a serve
    # run's ~10^5 of them into FunctionEvents took ~15 s (3a on the H100)
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if spans else [])
    try:
        with profile(activities=activities) as prof:
            _, _, traced = serve_once(model, reqs, capacity)
    finally:
        for label, (mod, fn) in spans.items():
            setattr(mod, fn, inner[label])
    # device-side events only (kernels, copies); the operator rows above
    # them would count the same device time twice, and so would the
    # device-side rows of the spans
    rows, spanned = device_rows(prof, spans)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    # the same requests do the same device work in every run; the profiler
    # slows the host, so the idle share is taken against run 2's wall time
    log(f"  device busy {busy:.3f} s | wall {warm:.3f} s (run 2), "
        f"{traced:.3f} s (run 3, traced) | idle share "
        f"{1 - busy / warm:.3f} (run 2), {1 - busy / traced:.3f} (run 3); "
        f"top kernels by device time:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  "
            f"{e.count:6d} calls  {e.key[:90]}")
    for label, (us, calls) in spanned.items():
        ms = us / 1e3
        log(f"  span {label}: {calls} calls, device time of its kernels "
            f"{ms:.2f} ms, {ms / 1e3 / busy:.3f} of device busy time")
    return rows, busy


def device_shares(rows, busy, groups):
    """Each kernel row goes to the first of ``groups`` (label, words) one of
    whose words its name holds (case and underscores ignored); prints the
    device ms, calls and share of busy time of each group and of the rest."""
    acc = {label: [0.0, 0] for label, _ in groups + [("the rest", ())]}
    for e in rows:
        name = e.key.lower().replace("_", "")
        label = next((lb for lb, words in groups
                      if any(w in name for w in words)), "the rest")
        acc[label][0] += e.self_device_time_total / 1e3
        acc[label][1] += e.count
    for label, (ms, n) in acc.items():
        log(f"  {label}: {ms:.2f} ms over {n} calls, {ms / 1e3 / busy:.3f} "
            f"of device busy time")


def _model(cfg, dtype):
    from repro_torch.models import build_model
    return build_model(cfg, device="cuda", dtype=dtype,
                       generator=torch.Generator("cuda").manual_seed(0))


def _arch(name):
    from repro_torch.configs import ARCHS
    return ARCHS[name]


#: phase 8's prefill: prompts of this many random tokens (seed 0), one
#: ``ServingEngine.prefill`` each, no reuse
CLOCK_PROMPTS, CLOCK_TOKENS = 4, 1024


def prefill_clock(model, reps=3):
    """The host-clock seconds of ``ServingEngine.prefill`` over
    ``CLOCK_PROMPTS`` prompts of ``CLOCK_TOKENS`` tokens, one after another
    and ended by a synchronise: warm (one pass first), the median of
    ``reps`` passes; and the device's busy seconds in one more pass
    (``torch.profiler``, its top kernels printed)."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(model)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=(CLOCK_TOKENS,))
               for _ in range(CLOCK_PROMPTS)]

    def one_pass():
        t0 = time.perf_counter()
        for p in prompts:
            eng.prefill(p)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    one_pass()
    times = sorted(one_pass() for _ in range(reps))
    log(f"  prefill of {CLOCK_PROMPTS} x {CLOCK_TOKENS} tokens, warm: "
        + ", ".join(f"{t:.4f}" for t in times) + " s (phase 8 reads the "
        "median)")
    _, busy = profile_step("the same prefills, profiled", one_pass)
    return times[reps // 2], busy / 1e3


def phase_serve_smollm():
    """3a; returns the launches and ``prefill_clock``'s times."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import make_requests

    log("[3a] serve: full-width smollm-360m (bf16, seed 0) behind "
        "DisaggServer(mfs), 2 prefill units, 8 decode slots x 1024")
    model = _model(_arch("smollm-360m"), torch.bfloat16)
    cfg = model.cfg
    reqs = make_requests(cfg, 16, 200.0, seed=0, mean_prompt=256, max_new=8)
    launches, res, steps = serve_counted(model, reqs, (flash_attention,
                                                       decode_attention))
    assert any(r.reused_tokens >= 32 for r in res), "no prefix reuse"
    assert launches["flash_attention"] >= len(reqs) * cfg.n_layers, launches
    assert launches["decode_attention"] >= cfg.n_layers * steps, launches
    rows, busy = serve_profiled(model, reqs)
    # the kernels read the 5 stored KV heads through the map: no expansion
    # copy of K/V (index_select) is left on the path
    device_shares(rows, busy, [(
        "index_select kernels (the embedding lookup's among them)",
        ("indexselect",))])
    return launches, prefill_clock(model)


def phase_serve_mamba2():
    from repro_torch.kernels.ssd_scan import ssd_chunked
    from repro_torch.launch.serve import agent_requests

    log("[3b] serve: full-width mamba2-1.3b (bf16, seed 0) behind "
        "DisaggServer(mfs), 2 prefill units, 8 decode slots; agent stream: "
        "3 warm 256-token prompts, 13 follow-ups (60% extend one by 32)")
    model = _model(_arch("mamba2-1.3b"), torch.bfloat16)
    cfg = model.cfg
    reqs = agent_requests(cfg, 13, seed=0, prompt=256, extend=32, fresh=288,
                          max_new=8)
    launches, res, steps = serve_counted(model, reqs, (ssd_chunked,),
                                         shapes="ssd")
    # a follow-up resumed a warm prompt's snapshot by suffix prefill
    assert any(r.reused_tokens >= 256 for r in res), "no snapshot resumed"
    assert launches["ssd_chunked"] >= cfg.n_layers * (len(reqs) + steps), \
        launches
    rows, busy = serve_profiled(model, reqs)
    # each SSD path apart (the dual form runs the prefills, the recurrence
    # the suffixes and the decode steps), and the copies left: decode
    # writes its state in place, so no per-step memcpy of the [8, 64, 64,
    # 128] state remains
    device_shares(rows, busy, [("ssd dual form, G = C B^T", ("gramkernel",)),
                               ("ssd dual form, the rest", ("dualkernel",)),
                               ("ssd recurrence", ("reckernel",)),
                               ("memcpys", ("memcpy",)),
                               ("copy kernels", ("directcopy",))])
    return launches


def phase_serve_hybrid():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.launch.serve import agent_requests

    log("[3c] serve-recurrentgemma-9b-agent-long: full-width "
        "recurrentgemma-9b (bf16, seed 0) behind DisaggServer(mfs), 2 "
        "prefill units, 8 decode slots x 4096; agent stream: 3 warm "
        "2112-token prompts, 13 follow-ups (60% extend one by 32), past the "
        "2048 window")
    model = _model(_arch("recurrentgemma-9b"), torch.bfloat16)
    cfg = model.cfg
    reqs = agent_requests(cfg, 13, seed=0, prompt=2112, extend=32,
                          fresh=2144, max_new=8)
    launches, res, steps = serve_counted(
        model, reqs, (rglru_scan, flash_attention, decode_attention),
        capacity=4096, shapes="rglru")
    # a follow-up resumed a warm prompt's snapshot by suffix prefill
    assert any(r.reused_tokens >= 2112 for r in res), "no snapshot resumed"
    n_attn = cfg.n_attn_layers()
    n_rec = cfg.n_layers - n_attn
    assert launches["rglru_scan"] >= n_rec * (len(reqs) + steps), launches
    assert launches["flash_attention"] >= n_attn * len(reqs), launches
    assert launches["decode_attention"] >= n_attn * steps, launches
    rows, busy = serve_profiled(model, reqs, capacity=4096)
    device_shares(rows, busy, [(w, (w,)) for w in (
        "flashmmakernel", "decodekernel", "combinekernel", "rglruscankernel",
        "memset")])
    return launches


def prefill_syncs(model, tokens):
    """The host synchronisations of one prefill, counted by PyTorch's sync
    debug mode (one warning each)."""
    import warnings

    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.prefill(tokens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    n = sum(sites.values())
    moe_layers = sum(s.count for s in model.segments if s.kinds[0][1])
    log(f"  host synchronisations in one prefill of {len(tokens)} tokens: "
        f"{n} ({moe_layers} MoE layers); by the line that made them: "
        + ", ".join(f"{k} x{v}" for k, v in sorted(sites.items()))
        if n else "  host synchronisations in one prefill: not measured "
        "(the sync debug mode gave no warning)")


def moe_decode_cost(model, slots=8):
    """One MoE layer at the decode step's shape (``slots`` tokens): the
    token-gather path (``_moe_token_gather``, what decode runs) and its
    weight gather alone, by graph replay; the grouped path on the same
    tokens eagerly (it reads its largest group on the host, so no graph
    holds it), and the two paths' agreement."""
    from repro_torch.models import blocks
    p, cfg = model.seg1[0][0].ffn_moe, model.cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(slots, 1, cfg.d_model, generator=g,
                    device="cuda").to(model.dtype)
    _, idx = blocks._route(x.reshape(slots, -1), p.router, cfg.top_k)
    check(f"moe[{slots} decode tokens] grouped vs token gather",
          blocks._moe_local(p, x, cfg), blocks._moe_token_gather(p, x, cfg),
          TOL[model.dtype])
    expert = 3 * cfg.d_model * cfg.d_expert * p.w_in.element_size()
    distinct = int(idx.unique().numel())
    gathered = idx.numel() * expert
    ms_gather = graph_ms(lambda: (p.w_in[idx], p.w_gate[idx], p.w_out[idx]))
    ms_path = graph_ms(lambda: blocks._moe_token_gather(p, x, cfg))
    ms_grouped = time_ms(lambda: blocks._moe_local(p, x, cfg))
    log(f"  one MoE layer, {slots} decode tokens x top-{cfg.top_k} over "
        f"{distinct} distinct experts: weight gather {ms_gather:.4f} ms "
        f"({gathered / 1e6:.1f} MB gathered: read and written, "
        f"{2 * gathered / ms_gather / 1e9:.3f} TB/s), token-gather path "
        f"{ms_path:.4f} ms (bound {3 * gathered / HBM_BW * 1e3:.4f} ms for "
        f"its 3 passes), grouped path {ms_grouped:.4f} ms eager, host "
        f"included (it reads all {cfg.n_experts} experts' weights once: "
        f"{cfg.n_experts * expert / HBM_BW * 1e3:.4f} ms at the HBM rate; "
        f"the {distinct} experts routed to need "
        f"{distinct * expert / HBM_BW * 1e3:.4f} ms)")


def phase_serve_moe():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import blocks

    log("[3d] serve-deepseek-moe-16b: full-width full-depth deepseek-moe-16b "
        "(bf16, seed 0) behind DisaggServer(mfs), 2 prefill units, 8 decode "
        "slots x 1024; 3a's stream: 16 requests, half on 4 Zipf-hot "
        "32-token prefixes")
    torch.cuda.reset_peak_memory_stats()
    model = _model(_arch("deepseek-moe-16b"), torch.bfloat16)
    cfg = model.cfg
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    plan = [(s.count, "moe" if s.kinds[0][1] else "dense")
            for s in model.segments]
    log(f"  weights {nbytes / 1e9:.2f} GB, plan {plan}")
    reqs = make_requests(cfg, 16, 200.0, seed=0, mean_prompt=256, max_new=8)
    launches, res, steps = serve_counted(model, reqs, (flash_attention,
                                                       decode_attention))
    assert any(r.reused_tokens >= 32 for r in res), "no prefix reuse"
    assert launches["flash_attention"] >= cfg.n_layers * len(reqs), launches
    assert launches["decode_attention"] >= cfg.n_layers * steps, launches
    rows, busy = serve_profiled(
        model, reqs, spans={"moe prefill (grouped)": (blocks, "_moe_local"),
                            "moe decode (token gather)": (
                                blocks, "_moe_token_gather")})
    device_shares(rows, busy, [
        ("flash_attention", ("flashmma", "flashf32")),
        ("decode_attention", ("decodekernel",)),
        ("split-KV combine", ("combinekernel",)),
        ("cuBLAS GEMM/GEMV", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
        ("group offsets (searchsorted)", ("searchsorted",)),
        ("sort (the expert argsort, top-k's)", ("sort",)),
        ("top-k", ("topk", "radixselect")),
        ("index, gather, scatter (the decode weight gather among them)",
         ("index", "gather", "scatter"))])
    prefill_syncs(model, reqs[0].tokens)
    moe_decode_cost(model)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    return launches


def phase_serve_dense(arch, label, rps=200.0, embeds=False):
    """3e, 3f, 3i: a dense model at full width and depth behind DisaggServer
    on 3a's stream (its requests at ``rps``), both attention kernels through
    its padded head map, and at least one request's suffix prefill over a
    reused 32-token paged prefix. ``embeds``: then one prefill from 256
    input embeddings, the stub frontend's shape. Returns the launches and
    ``prefill_clock``'s times."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.blocks import AttnDims

    torch.cuda.reset_peak_memory_stats()
    model = _model(_arch(arch), torch.bfloat16)
    cfg, dims = model.cfg, AttnDims.of(model.cfg)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{label}] serve: full-width full-depth {arch} ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads padded to "
        f"{dims.n_q} over {cfg.n_kv} KV heads, head dim {dims.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; bf16, seed 0, weights "
        f"{nbytes / 1e9:.2f} GB) behind DisaggServer(mfs), 2 prefill units, "
        f"8 decode slots x 1024; 3a's stream at {rps:g} requests/s: 16 "
        "requests, half on 4 Zipf-hot 32-token prefixes")
    reqs = make_requests(cfg, 16, rps, seed=0, mean_prompt=256, max_new=8)
    launches, res, steps = serve_counted(model, reqs, (flash_attention,
                                                       decode_attention))
    assert any(r.reused_tokens >= 32 for r in res), "no prefix reuse"
    assert launches["flash_attention"] >= cfg.n_layers * len(reqs), launches
    assert launches["decode_attention"] >= cfg.n_layers * steps, launches
    rows, busy = serve_profiled(model, reqs)
    device_shares(rows, busy, [
        ("flash_attention", ("flashmma", "flashf32")),
        ("decode_attention", ("decodekernel",)),
        ("split-KV combine", ("combinekernel",)),
        ("cuBLAS GEMM/GEMV", ("gemm", "gemv", "nvjet", "xmma", "cutlass"))])
    if embeds:
        g = torch.Generator(device=model.device).manual_seed(1)
        emb = torch.randn(1, 256, cfg.d_model, generator=g,
                          device=model.device) / cfg.d_model ** 0.5
        flash_attention.launches = 0
        t0 = time.perf_counter()
        lg, _ = model.prefill({"inputs_embeds": emb})
        torch.cuda.synchronize()
        log(f"  prefill from inputs_embeds {tuple(emb.shape)}: "
            f"{time.perf_counter() - t0:.3f} s, flash_attention launches "
            f"{flash_attention.launches}, next token "
            f"{int(lg[0, -1].argmax())}")
        assert flash_attention.launches == cfg.n_layers
        assert torch.isfinite(lg[..., :cfg.vocab]).all()
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    return launches, prefill_clock(model)


MLA_DEPTH = 4       # of 61: deepseek-v3's 3 dense layers and 1 MoE layer


def phase_serve_mla():
    """3h: deepseek-v3 at full width, depth cut to ``MLA_DEPTH`` (the MTP
    layer carried, never read), on 3a's stream: absorbed MLA over paged
    latents (plain products: no Pallas kernel computes MLA), 256 routed
    experts top-8 and a shared one."""
    import dataclasses

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import blocks, lm

    cfg = dataclasses.replace(_arch("deepseek-v3-671b"), n_layers=MLA_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    model = _model(cfg, torch.bfloat16)

    def gb(mods):
        return sum(p.numel() * p.element_size() for m in mods
                   for p in m.parameters()) / 1e9
    log(f"[3h] serve-deepseek-v3-depth4: deepseek-v3-671b at full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads, q rank "
        f"{cfg.q_lora_rank}, kv rank {cfg.kv_lora_rank}, rope "
        f"{cfg.rope_head_dim}, nope {cfg.nope_head_dim}, v "
        f"{cfg.v_head_dim}, {cfg.n_experts} routed experts top-{cfg.top_k} "
        f"of width {cfg.d_expert} + {cfg.n_shared} shared, vocab "
        f"{cfg.vocab}), depth cut 61 -> {cfg.n_layers} ({cfg.first_dense} "
        f"dense + {cfg.n_layers - cfg.first_dense} MoE); bf16, seed 0, "
        f"weights {gb([model]):.2f} GB, of which the MTP head (never read "
        f"by serving) {gb([model.mtp_layer, model.mtp_proj]):.2f} GB; behind "
        "DisaggServer(mfs), 2 prefill units, 8 decode slots x 1024; 3a's "
        "stream: 16 requests, half on 4 Zipf-hot 32-token prefixes")
    reqs = make_requests(cfg, 16, 200.0, seed=0, mean_prompt=256, max_new=8)
    with RoutingLog() as routes:
        _, res, _ = serve_counted(model, reqs, ())
    # the follow-up's suffix prefill ran over paged latents (c, kr)
    assert any(r.reused_tokens >= 32 for r in res), "no latent prefix reused"
    log(f"  routing: {len(routes.calls)} router calls, smallest "
        f"top-{cfg.top_k}/top-{cfg.top_k + 1} probability margin "
        f"{min(m for _, m in routes.calls):.3e}")
    rows, busy = serve_profiled(
        model, reqs, spans={"mla (absorbed attention)": (lm, "mla_apply"),
                            "moe prefill (grouped)": (blocks, "_moe_local"),
                            "moe decode (token gather)": (
                                blocks, "_moe_token_gather")})
    device_shares(rows, busy, [
        ("cuBLAS GEMM/GEMV", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
        ("softmax", ("softmax",)),
        ("sort (the expert argsort, top-k's)", ("sort",)),
        ("top-k", ("topk", "radixselect")),
        ("index, gather, scatter (the decode weight gather among them)",
         ("index", "gather", "scatter"))])
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")


def phase_serve_encdec():
    """3j: seamless-m4t-medium at full width and depth on an agent stream
    whose requests carry ``SEAMLESS_SRC`` seeded source frames (a follow-up
    its warm prompt's): the encoder and the cross-attention through the
    flash kernel without a mask, the decoder's self-attention with the
    causal one, the cross-attention at decode through the decode kernel; a
    follow-up resumes a warm prompt's snapshot and its cross K/V."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import agent_requests

    torch.cuda.reset_peak_memory_stats()
    model = _model(_arch("seamless-m4t-medium"), torch.bfloat16)
    cfg = model.cfg
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[3j] serve-seamless-m4t-medium: full width and depth ("
        f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab} padded to {model.vocab_padded}; bf16, seed 0, "
        f"weights {nbytes / 1e9:.2f} GB) behind DisaggServer(mfs), 2 "
        "prefill units, 8 decode slots x 1024; agent stream: 3 warm "
        "256-token prompts, 13 follow-ups (60% extend one by 32), "
        f"{SEAMLESS_SRC} source frames a request")
    reqs = agent_requests(cfg, 13, seed=0, prompt=256, extend=32, fresh=288,
                          max_new=8)
    assert {r.extra["src_embeds"].shape for r in reqs} == \
        {(1, SEAMLESS_SRC, cfg.d_model)}
    inner, masks = ops.attention, {"causal": 0, "non-causal": 0}

    def counted(*a, **kw):
        masks["causal" if kw.get("causal", True) else "non-causal"] += 1
        return inner(*a, **kw)
    ops.attention = counted
    try:
        launches, res, steps = serve_counted(
            model, reqs, (flash_attention, decode_attention))
    finally:
        ops.attention = inner
    full = sum(r.reused_tokens == 0 for r in res)
    log(f"  flash_attention calls by mask: {masks}; {full} full prefills, "
        f"{len(res) - full} over a snapshot")
    assert any(r.reused_tokens >= 256 for r in res), "no snapshot resumed"
    L, E = cfg.n_layers, cfg.enc_layers
    assert masks["causal"] == L * len(reqs), masks
    # the encoder runs for a full prefill only: a resumed one reads the
    # snapshot's cross K/V
    assert masks["non-causal"] == E * full + L * len(reqs), masks
    assert launches["flash_attention"] == sum(masks.values()), launches
    # each step: self- and cross-attention in every decoder layer
    assert launches["decode_attention"] >= 2 * L * steps, launches
    rows, busy = serve_profiled(model, reqs)
    device_shares(rows, busy, [
        ("flash_attention", ("flashmma", "flashf32")),
        ("decode_attention", ("decodekernel",)),
        ("split-KV combine", ("combinekernel",)),
        ("cuBLAS GEMM/GEMV", ("gemm", "gemv", "nvjet", "xmma", "cutlass"))])
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    return launches


QWEN_DEPTH = 16     # of 64: what fits one card beside an int8 cache (3g)


def prefill_into(model, tokens, caches, slot):
    """One prompt through ``Model.prefill`` with a sink: each layer's K/V
    are stored into slot ``slot`` of the decode ``caches`` as they hold it
    (the real KV heads, through ``_kv_store`` into the caches' dtype) before
    the next layer runs, so that a 32k prompt's cache of every layer is
    never held at once. Returns the logits of its last position."""
    from repro_torch.models.blocks import _kv_store
    n = len(tokens)

    def sink(si, i, c, nc):
        for name, leaf in caches[si][i]["mix"].items():
            leaf[c, slot, :n] = _kv_store(
                nc["mix"][name][0, :, :leaf.shape[3]], leaf.dtype)
    logits, _ = model.prefill({"tokens": np.asarray(tokens)[None]},
                              sink=sink)
    return logits


def decode_timed(model, caches, tok, pos, steps=5):
    """Decode steps with the same tokens at the same positions (each writes
    the same K/V into the same slots): the host-clock seconds of one step,
    ended by a synchronise, and the last step's logits."""
    for _ in range(2):
        model.decode_step(caches, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, _ = model.decode_step(caches, tok, pos)
    torch.cuda.synchronize()
    return lg, (time.perf_counter() - t0) / steps


def profile_step(label, fn):
    """One call of ``fn`` under ``torch.profiler``: its device time and the
    top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, _ = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  {label}: device time {busy:.3f} ms; top kernels:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} "
            f"calls  {e.key[:100]}")
    return rows, busy


def qwen_decode(model, prompts, B, kv_dtype, first=None):
    """A decode cache of ``B`` sequences x ``QWEN_S`` slots in ``kv_dtype``,
    the prompts prefilled into it (only ``prompts[0]`` when ``first`` is
    given: its K/V are copied into the other slots, as the step's time does
    not depend on what they hold, and ``first`` is its first token), then
    decode steps timed and one profiled. The cache lives in this call
    only. Returns the first tokens, slot 0's logits (float32, the real
    vocab), the host-clock seconds and device ms of a step, the decode
    kernel's launches over the timed steps and the device memory allocated
    beyond the cache during them."""
    from repro_torch.kernels.decode_attention import decode_attention
    lens = [len(p) for p in prompts[:B]]
    caches = model.init_cache(B, QWEN_S, kv_dtype=kv_dtype)
    t0 = time.perf_counter()
    if first is None:
        firsts = [int(prefill_into(model, p, caches, b)[0, -1].argmax())
                  for b, p in enumerate(prompts[:B])]
    else:
        prefill_into(model, prompts[0], caches, 0)
        for seg in caches:
            for layer in seg:
                for leaf in layer["mix"].values():
                    leaf[:, 1:] = leaf[:, :1]
        firsts, lens = [first] * B, [lens[0]] * B
    torch.cuda.synchronize()
    log(f"  {kv_dtype}: {B if first is None else 1} prefill(s) of "
        f"{min(lens)}-{max(lens)} tokens, layer by layer into the cache: "
        f"{time.perf_counter() - t0:.3f} s")
    tok = torch.tensor(firsts, device=model.device)[:, None]
    pos = torch.tensor(lens, device=model.device)
    decode_attention.launches = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lg, t = decode_timed(model, caches, tok, pos)
    extra = torch.cuda.max_memory_allocated() - base
    launches = decode_attention.launches
    _, dev = profile_step(f"{kv_dtype} decode step, B={B}",
                          lambda: model.decode_step(caches, tok, pos))
    return (firsts, lg[0, -1, :model.cfg.vocab].float(), t, dev, launches,
            extra)


def phase_qwen_int8():
    """3g: qwen1.5-32b at full width, depth cut to ``QWEN_DEPTH``, decoding 8
    sequences of ~32k tokens from an int8 KV cache read by the decode
    kernel; held against a step over the bf16 cache of the same prefill.
    Returns the decode kernel's launches and, for phase 8, each step's
    (K/V bytes an element, batch, mean keys read, host-clock seconds,
    device ms)."""
    import dataclasses

    from repro_torch.models.blocks import AttnDims

    cfg = dataclasses.replace(_arch("qwen1.5-32b"), n_layers=QWEN_DEPTH)
    model = _model(cfg, torch.bfloat16)
    dims = AttnDims.of(cfg)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    total = torch.cuda.get_device_properties(0).total_memory

    def per_seq(nbytes):          # one sequence's K/V of every layer
        return 2 * cfg.n_layers * QWEN_S * cfg.n_kv * dims.hd * nbytes
    work = 12e9                   # a 32k prefill's activations, with margin
    log(f"[3g] decode-qwen1.5-32b-int8-32k: full width ({cfg.d_model}, "
        f"{cfg.n_heads} MHA heads padded to {dims.n_q}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}), depth {cfg.n_layers} of 64; bf16 weights "
        f"{weights / 1e9:.2f} GB, seed 0; card {total / 1e9:.2f} GB; 8 "
        f"sequences x {QWEN_S} slots of {cfg.n_kv} KV heads: int8 "
        f"{8 * per_seq(1) / 1e9:.2f} GB, bf16 {8 * per_seq(2) / 1e9:.2f} GB")
    assert weights + 8 * per_seq(2) > total, "a bf16 cache at B=8 would fit"
    assert weights + 8 * per_seq(1) + work < total
    b16 = max(1, min(8, int((total - weights - work) // per_seq(2))))
    rng = np.random.default_rng(0)
    lens = [QWEN_S - 1 - 97 * b for b in range(8)]      # decode at pos < S
    prompts = [rng.integers(0, cfg.vocab, size=(n,)) for n in lens]

    # int8: every sequence prefilled and stored as codes
    firsts, lg8, t8, dev8, launches, extra = qwen_decode(
        model, prompts, 8, torch.int8)
    gc_cuda()
    log(f"  device memory allocated after the int8 pass "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    # bf16, at the batch that fits beside the weights and a prefill, from
    # the int8 pass's first token of sequence 0
    _, lg16, t16, dev16, _, _ = qwen_decode(model, prompts, b16,
                                            torch.bfloat16, first=firsts[0])
    keys = sum(lens) + 8
    cache_read = 2 * cfg.n_layers * keys * cfg.n_kv * dims.hd
    log(f"  decode step, host clock: int8 B=8 {t8 * 1e3:.3f} ms "
        f"({8 / t8:.1f} tokens/s), bf16 B={b16} {t16 * 1e3:.3f} ms "
        f"({b16 / t16:.1f} tokens/s); device time {dev8:.3f} vs "
        f"{dev16:.3f} ms; bytes an int8 step reads: weights "
        f"{weights / 1e9:.2f} GB + K/V codes {cache_read / 1e9:.2f} GB, "
        f"{(weights + cache_read) / HBM_BW * 1e3:.3f} ms at 3.35 TB/s")
    log(f"  decode_attention launches over the {2 + 5} int8 steps: "
        f"{launches}; device memory beyond the caches during them "
        f"{extra / 1e6:.1f} MB (a bf16 copy of one layer's int8 K/V would be "
        f"{per_seq(2) * 8 / cfg.n_layers / 1e9:.2f} GB)")
    assert launches == cfg.n_layers * 7, launches
    assert extra < 1e9, "the int8 step allocated a dequantised copy"
    # the JAX model's criterion (tests/test_models.py): the step over the
    # int8 codes against the step over the bf16 cache of the same prefill
    a, b = torch.softmax(lg16, -1), torch.softmax(lg8, -1)
    tv = float((a - b).abs().sum())
    log(f"  int8 vs bf16, sequence 0: total variation {tv:.4f} (limit 0.25),"
        f" argmax {int(a.argmax())} vs {int(b.argmax())}")
    if not (tv < 0.25 and int(a.argmax()) == int(b.argmax())):
        raise SystemExit("qwen1.5-32b: the int8 decode step strays from bf16")
    assert torch.isfinite(lg8).all() and torch.isfinite(lg16).all()
    # a step at position pos reads pos + 1 keys; the bf16 pass copies
    # sequence 0's cache into every slot
    steps = [(1, 8, sum(lens) / 8 + 1, t8, dev8),
             (2, b16, lens[0] + 1, t16, dev16)]
    return {"decode_attention": launches, "steps": steps}


def gc_cuda():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 4
def _admit(model, caches, n):
    """The B=1 prefill ``caches`` of an ``n``-token prompt as
    ``DecodeBatch.add`` admits them into one slot of a batch with room for
    the 4 decode steps: full-attention k/v padded, a window leaf rolled
    into its ring, state leaves as they are."""
    from repro_torch.serving import DecodeBatch
    batch = DecodeBatch(model, capacity=n + 8, max_slots=1)
    batch.add(0, caches, n, first_token=0)
    return batch._stacked             # the stacked caches the step reads


class RoutingLog:
    """Within ``with``, every ``_route`` call records the chosen experts
    (sorted per token) and the smallest margin between the top-k-th and the
    next expert's probability (``calls``), and each token's margin
    (``margins``)."""

    def __init__(self):
        self.calls, self.margins = [], []

    def __enter__(self):
        from repro_torch.models import blocks
        self._inner = inner = blocks._route

        def route(x_flat, router, top_k):
            gates, idx = inner(x_flat, router, top_k)
            probs = torch.softmax(x_flat.float() @ router, dim=-1)
            top = torch.topk(probs, top_k + 1, dim=-1).values
            margin = (top[:, -2] - top[:, -1]).cpu()
            self.calls.append((idx.sort(-1).values.cpu(),
                               float(margin.min())))
            self.margins.append(margin)
            return gates, idx
        blocks._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks._route = self._inner


def _admit_int8(model, caches, n):
    """The B=1 prefill ``caches`` of an ``n``-token prompt stored as int8
    codes in a cache laid out as ``init_cache`` lays it (the real KV heads),
    with room for the 4 decode steps."""
    from repro_torch.models.blocks import _kv_store
    out = model.init_cache(1, n + 8, kv_dtype=torch.int8)
    for seg_o, seg_p in zip(out, caches):
        for lo, lp in zip(seg_o, seg_p):
            for name, leaf in lo["mix"].items():
                leaf[:, :, :n] = _kv_store(
                    lp["mix"][name][:, :, :, :leaf.shape[3]], torch.int8)
    return out


def phase_whole_model(arch, n_layers=None, n=256, int8=False, changes=None,
                      embeds=False, src_len=0):
    """``int8``: the decode steps run over int8 caches on both sides, and the
    codes that differ card vs CPU are counted. ``changes``: other config
    fields cut (an encoder-decoder's ``enc_layers``, ``n_experts``).
    ``embeds``: the prompt and the decode steps are input embeddings (seeded,
    N(0, 1/d)); ``src_len``: the prefill carries that many seeded source
    frames."""
    import contextlib
    import dataclasses

    from repro_torch.models import build_model

    cfg = _arch(arch)
    depth = "full"
    if n_layers is not None or changes:
        cfg = dataclasses.replace(cfg, **(changes or {}),
                                  **({} if n_layers is None
                                     else {"n_layers": n_layers}))
        depth = f"cut: {dict(n_layers=n_layers, **(changes or {}))}"
    log(f"[4] whole model {arch}, float32: kernels on the card vs plain on "
        "the CPU")
    gpu = _model(cfg, torch.float32)
    log(f"  depth {cfg.n_layers} layers ({depth}), d_model {cfg.d_model}, "
        f"prompt {n} {'embeddings' if embeds else 'tokens'}"
        f"{f', {src_len} source frames' if src_len else ''}, "
        f"{sum(p.numel() for p in gpu.parameters()) / 1e9:.2f} B parameters")
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(1, n + 4))
    batch = {"tokens": toks[:, :n]}
    feeds = [toks[:, n + s:n + s + 1] for s in range(4)]
    if embeds:
        emb = (rng.normal(size=(1, n + 4, cfg.d_model))
               / np.sqrt(cfg.d_model)).astype(np.float32)
        batch = {"inputs_embeds": emb[:, :n]}
        feeds = [emb[:, n + s:n + s + 1] for s in range(4)]
    if src_len:
        batch["src_embeds"] = rng.normal(
            size=(1, src_len, cfg.d_model)).astype(np.float32)
    diffs, scale = [], 0.0
    outs, routes, codes = {}, {}, {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        with (RoutingLog() if cfg.n_experts
              else contextlib.nullcontext()) as routes[name]:
            lg, caches = m.prefill(batch)
            steps = [lg]
            caches = (_admit_int8 if int8 else _admit)(m, caches, n)
            for s in range(4):
                lg, caches = m.decode_step(caches, feeds[s], n + s)
                steps.append(lg)
        # the real vocab only: padded logits are -1e30 on both sides
        outs[name] = [x[..., :cfg.vocab].float().cpu() for x in steps]
        if int8:
            codes[name] = [leaf.cpu() for seg in caches for layer in seg
                           for leaf in layer["mix"].values()]
        log(f"  {name}: prefill + 4 decode steps {time.perf_counter() - t0:.3f} s")
    for a, b in zip(outs["cuda"], outs["cpu"]):
        diffs.append(float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    rel = max(diffs) / scale
    # float32 on both sides, TF32 off: only the order of summation differs
    # (cuBLAS vs the CPU GEMM, the kernels' online softmax and sequential
    # scan vs the plain versions), ~1e-6 relative per op, compounding over
    # the layers; 1e-3 of the largest logit leaves two orders of margin and
    # still catches a wrong mask, position, cache write or state carry
    # (those move logits by O(1) of scale)
    log(f"  max |logit diff| per step {['%.3e' % d for d in diffs]}, "
        f"max |logit| {scale:.3f}, relative {rel:.3e} (tol 1e-3)")
    if cfg.n_experts:
        # routing is discontinuous: a near tie between the top-k-th and the
        # next expert could flip under summation-order differences; a
        # failure with no routing difference is a fault of the path
        calls = list(zip(routes["cuda"].calls, routes["cpu"].calls))
        differ = sum(not torch.equal(a[0], b[0]) for a, b in calls)
        margin = min(m for a, b in calls for m in (a[1], b[1]))
        log(f"  routing: {len(calls)} router calls a side, smallest "
            f"top-{cfg.top_k}/top-{cfg.top_k + 1} probability margin "
            f"{margin:.3e}, calls whose experts differ card vs CPU: {differ}")
    if int8:
        # a K or V value within float32 rounding of a code boundary (x * 32
        # at k + 1/2) may land on the other code card vs CPU: reported
        differ = sum(int((a != b).sum()) for a, b in zip(codes["cuda"],
                                                         codes["cpu"]))
        n_codes = sum(a[:, :, :n + 4].numel() for a in codes["cpu"])
        log(f"  int8 caches: {differ} of {n_codes} codes differ card vs CPU "
            f"after the prefill and 4 decode steps")
    if not rel <= 1e-3:
        raise SystemExit(f"{arch}: whole-model logits disagree between card "
                         "and CPU")
    del gpu, cpu
    torch.cuda.empty_cache()
    return rel


# ---------------------------------------------------------- phases 4t and 5
#: full-width smollm-360m's training batch (phase 5)
TRAIN_B, TRAIN_T = 8, 1024
#: full-width full-depth mamba2-1.3b's (5m, and row 3bwd's shape): phase 5's
#: B=8 x 1024 peaks above the ~72 GB this phase allows itself on the 80 GB
#: card (80.06 GB by tools/train_probe.py, PERF.md), so B=4
MAMBA_TRAIN_B, MAMBA_TRAIN_T = 4, 1024
#: 5m's depth (of 48): each checkpoint moves the state through the disk
#: (~13 GB at full depth), and the smoke has a time limit
MAMBA_TRAIN_DEPTH = 24
#: recurrentgemma-9b's (5r, and row 4bwd's shape): past its 2048 window, so
#: the attention backward runs row 5r's masks; cut to RG_TRAIN_DEPTH layers
#: (whole (rec, rec, attn) units), the deepest whose peak stays under ~72
#: GB (depth 6 peaked at 68.84 GB by tools/train_probe.py, 9 at 75.97, 12
#: ran out of the card's memory; PERF.md): full depth would need ~115 GB
#: for bf16 weights and gradients and float32 moments
RG_TRAIN_B, RG_TRAIN_T, RG_TRAIN_DEPTH = 1, 2112, 6


#: the launch counters of the kernels on the training paths
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_chunked",
                 "ssd_chunked_bwd", "rglru_scan", "rglru_scan_bwd")


def _wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, ssd_scan
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_chunked": ssd_scan.ssd_chunked,
            "ssd_chunked_bwd": ssd_scan.ssd_chunked_bwd,
            "rglru_scan": rglru.rglru_scan,
            "rglru_scan_bwd": rglru.rglru_scan_bwd}


def zero_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {n: fn.launches for n, fn in _wrappers().items()}


def phase_train_grads(arch, n_layers, B, T, expect):
    """4t: the loss and every parameter's gradient of full-width ``arch``
    cut to ``n_layers``, float32, through the kernels on the card (each
    forward and its backward; ``expect``: the launches of each, the others
    none) and through the plain versions on the CPU: the same weights from
    seed 0, the same batch."""
    import dataclasses

    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import build_model

    cfg = dataclasses.replace(_arch(arch), n_layers=n_layers)
    log(f"[4t] gradients of {arch} at full width, depth {n_layers}, "
        f"float32, B={B} T={T}: kernels on the card vs plain on the CPU")
    gpu = _model(cfg, torch.float32)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict(gpu.state_dict())
    batch = synthetic_batch(cfg, B, T, seed=0, step=0, device="cuda")
    grads, losses = {}, {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        m.requires_grad_(True)
        zero_launches()
        loss = m.loss({k: v.to(m.device) for k, v in batch.items()})
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {n: p.grad.float().cpu() for n, p in
                       m.named_parameters()}
        if name == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
            log(f"  cuda: kernel launches {launches}")
            want = {n: expect.get(n, 0) for n in TRAIN_KERNELS}
            assert launches == want, (launches, want)
    # float32 on both sides, TF32 off: only the order of summation differs
    # (cuBLAS vs the CPU GEMM, the kernels' online softmax, blocked
    # backward and chunked scans vs the plain versions), ~1e-6 relative per
    # op; each gradient is held to 1e-3 of its own largest value, as the
    # whole-model logits of phase 4 are: a gradient that autograd lost (a
    # kernel's output taken as a constant) or a wrong mask, map or chunk
    # moves it by O(1)
    worst, worst_name = 0.0, None
    assert grads["cuda"].keys() == grads["cpu"].keys()
    for n, want in grads["cpu"].items():
        top = float(want.abs().max())
        assert top > 0, f"{n}: zero gradient on the CPU"
        rel = float((grads["cuda"][n] - want).abs().max()) / top
        if rel > worst:
            worst, worst_name = rel, n
    rel_loss = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"  loss card {losses['cuda']:.6f} cpu {losses['cpu']:.6f} "
        f"(relative {rel_loss:.2e}, tol 1e-5); {len(grads['cpu'])} "
        f"parameters' gradients, the largest difference over the "
        f"gradient's largest value {worst:.3e} ({worst_name}; tol 1e-3)")
    if not (rel_loss <= 1e-5 and worst <= 1e-3):
        raise SystemExit(f"{arch}: gradients disagree between card and CPU")
    del gpu, cpu
    return worst


def phase_train(steps=6, ckpt_at=3):
    """5: ``repro_torch.launch.train.run`` on full-width full-depth
    smollm-360m in bf16, B=8, T=1024, lr 1e-3, warmup 10, seed 0: ``steps``
    steps with a checkpoint at ``ckpt_at`` into a temp dir, then a run
    resumed from it to ``steps``, held to the straight run's parameters;
    then 20 steps over one repeated batch, whose loss must fall by more
    than 1.0 (the JAX package's test_train_loss_decreases); then one warm
    step timed and one under ``torch.profiler``. Returns the launch counts
    of the straight run."""
    import tempfile

    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = _arch("smollm-360m")
    log(f"[5] train: full-width full-depth smollm-360m (bf16, seed 0), "
        f"B={TRAIN_B} T={TRAIN_T}, lr 1e-3, warmup 10, AdamW")
    kw = dict(smoke=False, batch=TRAIN_B, seq=TRAIN_T, lr=1e-3, warmup=10,
              seed=0, log_every=1, device="cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        zero_launches()
        t0 = time.perf_counter()
        straight, losses = launch.run("smollm-360m", steps=steps,
                                      ckpt_dir=ckpt, ckpt_every=ckpt_at, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k for n, k in read_launches().items()
                    if n.startswith("flash")}
        log(f"  straight run: {steps} steps in {wall:.2f} s (first step "
            f"included), losses {['%.4f' % x for x in losses]}, launches "
            f"{launches}")
        assert all(np.isfinite(losses)) and len(losses) == steps
        assert launches["flash_attention"] == steps * cfg.n_layers, launches
        assert launches["flash_attention_bwd"] == steps * cfg.n_layers, \
            launches
        # the straight run also saved at ``steps``: drop that checkpoint,
        # so that the resume starts from ``ckpt_at``
        shutil.rmtree(os.path.join(ckpt, f"step_{steps:08d}"))
        resumed, more = launch.run("smollm-360m", steps=steps,
                                   ckpt_dir=ckpt, ckpt_every=0, resume=True,
                                   **kw)
        assert len(more) == steps - ckpt_at and all(np.isfinite(more))
        diff = max(float((a.detach().float() - b.detach().float()).abs()
                         .max()) for a, b in zip(straight.params.values(),
                                                 resumed.params.values()))
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(straight.params.values(),
                          resumed.params.values()))
        log(f"  resumed at step {ckpt_at}: losses "
            f"{['%.4f' % x for x in more]} (straight "
            f"{['%.4f' % x for x in losses[ckpt_at:]]}); final parameters "
            f"bitwise equal to the straight run's: {bitwise}, largest "
            f"difference {diff:.3e}")
        if not bitwise:
            raise SystemExit("phase 5: the resumed run's parameters differ "
                             "from the straight run's")
        del straight, resumed
        gc_cuda()

    # 20 steps over one repeated batch: the loss falls
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    opt = AdamWConfig(lr=1e-3, warmup=10)
    state = init_train_state(model, torch.Generator("cuda").manual_seed(0),
                             opt)
    step_fn = make_train_step(model, opt)
    batch = launch.synthetic_batch(cfg, TRAIN_B, TRAIN_T, 0, 0)
    fixed = []
    for _ in range(20):
        state, metrics = step_fn(state, batch)
        fixed.append(float(metrics["loss"]))
    log(f"  20 steps over one batch: losses {['%.3f' % x for x in fixed]}")
    assert fixed[-1] < fixed[0] - 1.0, (fixed[0], fixed[-1])

    # warm steps: the time a step, then one under the profiler
    state = profile_train_step(step_fn, state, batch, TRAIN_B * TRAIN_T)
    MEASURED["5"] = torch.cuda.max_memory_allocated() / 1e9
    del model, state
    return launches


#: device-share groups of a traced train step (kernel names, lower case
#: without underscores): the attention kernels, the scans' (the SSD forward
#: lives in ``dual::``/``rec::``, its backward's kernels are ``ssd_bwd_*``)
ATTN_GROUPS = [
    ("attention forward (flash_mma_kernel)", ("flashmma",)),
    ("attention backward (delta, dkdv, sum_splits, dq kernels)",
     ("dkdvwgmma", "dqwgmma", "deltakernel", "sumsplits"))]
SSD_GROUPS = [
    ("SSD forward (gram + dual_kernel, rec_kernel)", ("dual::", "rec::")),
    ("SSD backward (ssd_bwd_* kernels)", ("ssdbwd",))]
RGLRU_GROUPS = [
    ("RG-LRU forward (rglru_scan_kernel)", ("rglruscankernel",)),
    ("RG-LRU backward (rglru_scan_bwd_kernel)", ("rglruscanbwdkernel",))]
GEMM_GROUP = ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90"))


def profile_train_step(step_fn, state, batch, tokens, reps=5,
                       groups=ATTN_GROUPS):
    """Time ``reps`` warm steps (host clock to a sync), then trace one under
    ``torch.profiler``: ms a step, tokens a second, peak memory since the
    caller's reset, device busy time and idle share, the top kernels and the
    device shares of ``groups`` of kernels, the GEMMs and the ``optimizer``
    span. Returns the state after the steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.training import trainer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state, metrics = step_fn(state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  warm step {ms:.2f} ms ({reps} steps, host clock to a sync), "
        f"{tokens / ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GB "
        f"(weights, AdamW moments, activations, the float32 logits and "
        f"their gradient)")
    inner = trainer.adamw_update

    def spanned(*a, **k):
        with record_function("optimizer"):
            return inner(*a, **k)
    trainer.adamw_update = spanned
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = step_fn(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
    finally:
        trainer.adamw_update = inner
    rows, spanned = device_rows(prof, ("optimizer",))
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"  one warm step traced: device busy {busy * 1e3:.2f} ms | idle "
        f"share {1 - busy / (ms / 1e3):.3f} of the untraced step's "
        f"{ms:.2f} ms; top kernels by device time:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  "
            f"{e.count:6d} calls  {e.key[:90]}")
    device_shares(rows, busy, list(groups) + [GEMM_GROUP])
    for us, _ in spanned.values():
        opt_ms = us / 1e3
        log(f"  span optimizer (adamw_update): device time of its "
            f"kernels {opt_ms:.2f} ms, {opt_ms / 1e3 / busy:.3f} of "
            f"device busy time")
    return state


#: starcoder2-3b's training batch (phase 5s)
TRAIN_S_B, TRAIN_S_T = 2, 1024


def phase_train_starcoder2(steps=3):
    """5s: the launcher's loop (``launch.train.train_loop``, which ``run``
    runs) on full-width full-depth starcoder2-3b in bf16 (30 layers, 24 heads padded to 32 over 2 KV heads
    in groups of 12 and 20, head dim 128; bf16 parameters, float32 AdamW
    moments), B=2, T=1024, lr 1e-3, warmup 10, seed 0: ``steps`` straight
    steps with finite losses, each attention kernel launched steps x 30
    times; then warm steps timed and one traced on the model the run
    trained. The backward runs starcoder2's 32 over 2 (row 5s) here, split
    over the query heads. Returns the launch counts."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch import train as launch

    cfg = _arch("starcoder2-3b")
    log(f"[5s] train: full-width full-depth starcoder2-3b (bf16, seed 0), "
        f"B={TRAIN_S_B} T={TRAIN_S_T}, lr 1e-3, warmup 10, AdamW")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    # the launcher's loop itself (``run`` returns no train step)
    state, losses, step_fn = launch.train_loop(
        cfg, steps=steps, batch=TRAIN_S_B, seq=TRAIN_S_T, lr=1e-3,
        warmup=10, seed=0, log_every=1, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k for n, k in read_launches().items()
                if n.startswith("flash")}
    log(f"  straight run: {steps} steps in {wall:.2f} s (first step "
        f"included), losses {['%.4f' % x for x in losses]}, launches "
        f"{launches}, the backward's split of each KV head's query heads "
        f"{flash_attention_bwd.n_split}")
    assert all(np.isfinite(losses)) and len(losses) == steps
    for n in launches:
        assert launches[n] == steps * cfg.n_layers, launches
    batch = launch.synthetic_batch(cfg, TRAIN_S_B, TRAIN_S_T, 0, steps)
    state = profile_train_step(step_fn, state, batch, TRAIN_S_B * TRAIN_S_T,
                               reps=3)
    del state, step_fn
    return launches


def phase_train_mamba2(steps=3, ckpt_at=2):
    """5m: the launcher's loop (``launch.train.train_loop``, which ``run``
    runs) on full-width mamba2-1.3b cut to ``MAMBA_TRAIN_DEPTH`` of its 48
    layers in bf16 (d_model 2048, 64 heads of 64, state 128; bf16
    parameters, float32 AdamW moments), B=4 x 1024, lr 1e-3, warmup 10,
    seed 0: ``steps`` straight steps with a checkpoint at ``ckpt_at``,
    then the loop resumed from it and held bitwise to the straight run's
    parameters (the SSD backward's determinism gate); finite losses;
    ``ssd_chunked`` and ``ssd_chunked_bwd`` each launched steps x depth
    times; then warm steps timed and one traced on the resumed model.
    Returns the straight run's launch counts."""
    import dataclasses
    import tempfile

    from repro_torch.launch import train as launch

    cfg = dataclasses.replace(_arch("mamba2-1.3b"),
                              n_layers=MAMBA_TRAIN_DEPTH)
    log(f"[5m] train: full-width mamba2-1.3b at depth {MAMBA_TRAIN_DEPTH} "
        f"(bf16, seed 0), B={MAMBA_TRAIN_B} T={MAMBA_TRAIN_T} (B=8 at "
        f"full depth peaks above 72 GB), lr 1e-3, warmup 10, AdamW")
    kw = dict(batch=MAMBA_TRAIN_B, seq=MAMBA_TRAIN_T, lr=1e-3, warmup=10,
              seed=0, log_every=1, device="cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        straight, losses, _ = launch.train_loop(
            cfg, steps=steps, ckpt_dir=ckpt, ckpt_every=ckpt_at, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        log(f"  straight run: {steps} steps in {wall:.2f} s (first step and "
            f"the checkpoint at {ckpt_at} included), losses "
            f"{['%.4f' % x for x in losses]}, launches {launches}, peak "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        assert all(np.isfinite(losses)) and len(losses) == steps
        for n in ("ssd_chunked", "ssd_chunked_bwd"):
            assert launches[n] == steps * cfg.n_layers, launches
        want = {n: p.detach() for n, p in straight.params.items()}
        del straight
        gc_cuda()
        t0 = time.perf_counter()
        resumed, more, step_fn = launch.train_loop(
            cfg, steps=steps, ckpt_dir=ckpt, ckpt_every=0, resume=True, **kw)
        torch.cuda.synchronize()
        assert len(more) == steps - ckpt_at and all(np.isfinite(more))
        bitwise = all(torch.equal(want[n], p) for n, p in
                      resumed.params.items())
        diff = max(float((want[n].float() - p.detach().float()).abs().max())
                   for n, p in resumed.params.items())
        log(f"  resumed at step {ckpt_at} in {time.perf_counter() - t0:.2f} "
            f"s: losses {['%.4f' % x for x in more]} (straight "
            f"{['%.4f' % x for x in losses[ckpt_at:]]}); final parameters "
            f"bitwise equal to the straight run's: {bitwise}, largest "
            f"difference {diff:.3e}")
        if not bitwise:
            raise SystemExit("phase 5m: the resumed run's parameters differ "
                             "from the straight run's")
        del want
        gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    batch = launch.synthetic_batch(cfg, MAMBA_TRAIN_B, MAMBA_TRAIN_T, 0,
                                   steps)
    state = profile_train_step(step_fn, resumed, batch,
                               MAMBA_TRAIN_B * MAMBA_TRAIN_T, reps=3,
                               groups=SSD_GROUPS)
    del state, step_fn, resumed
    return launches


def phase_train_hybrid(steps=3):
    """5r: the launcher's loop (``launch.train.train_loop``) on
    recurrentgemma-9b at full width (d_model 4096, RG-LRU width 4096, 16
    query heads over one KV head of 256, window 2048, vocab 256000), depth
    cut to RG_TRAIN_DEPTH layers of whole (rec, rec, attn) units, bf16
    parameters and float32 AdamW moments, B=1 x 2112 (past the window, so
    the attention backward runs row 5r's masks), lr 1e-3, warmup 10, seed
    0: ``steps`` steps with finite losses, ``rglru_scan``/``rglru_scan_bwd``
    launched steps x (recurrent layers) times and the attention kernels
    steps x (attention layers); then warm steps timed and one traced.
    Returns the launch counts."""
    import dataclasses

    from repro_torch.launch import train as launch

    full = _arch("recurrentgemma-9b")
    cfg = dataclasses.replace(full, n_layers=RG_TRAIN_DEPTH)
    n_attn = cfg.n_attn_layers()
    n_rec = cfg.n_layers - n_attn
    reduced = {"n_layers": [full.n_layers, cfg.n_layers]}
    log(f"[5r] train: recurrentgemma-9b at full width (bf16, seed 0), "
        f"depth {cfg.n_layers} ({n_rec} recurrent, {n_attn} attention), "
        f"{cfg.params() / 1e9:.2f} B parameters, B={RG_TRAIN_B} "
        f"T={RG_TRAIN_T}, lr 1e-3, warmup 10, AdamW; reduced "
        f"{json.dumps(reduced)}")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    state, losses, step_fn = launch.train_loop(
        cfg, steps=steps, batch=RG_TRAIN_B, seq=RG_TRAIN_T, lr=1e-3,
        warmup=10, seed=0, log_every=1, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"  {steps} steps in {wall:.2f} s (first step included), losses "
        f"{['%.4f' % x for x in losses]}, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    assert all(np.isfinite(losses)) and len(losses) == steps
    want = {"rglru_scan": n_rec, "rglru_scan_bwd": n_rec,
            "flash_attention": n_attn, "flash_attention_bwd": n_attn}
    for n, per_step in want.items():
        assert launches[n] == steps * per_step, launches
    batch = launch.synthetic_batch(cfg, RG_TRAIN_B, RG_TRAIN_T, 0, steps)
    state = profile_train_step(step_fn, state, batch,
                               RG_TRAIN_B * RG_TRAIN_T, reps=3,
                               groups=RGLRU_GROUPS + ATTN_GROUPS)
    del state, step_fn
    return launches


# ------------------------------------------------------------------ phase 6
#: every rank of a mesh phase runs on the one card; gloo carries the
#: collectives through host memory (NCCL takes one rank a device)
P6_DEVICE = "cuda:0"
#: greedy decode steps of the mesh phases
P6_STEPS = 8
#: 6a's training: phase 5's optimizer settings, at a depth cut (of 32: a
#: step moves every weight's TP sums through gloo's host memory; at full
#: depth 6a alone took 63-104 s of the smoke's time limit)
P6_TRAIN = dict(lr=1e-3, warmup=10, seed=0)
P6_TRAIN_DEPTH = 8
#: 6b's prompts served again with the EP sums in rank order (the fourth of
#: odd length)
P6_WITNESS = 4


def _p6_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)


def _p6_ctx(model_par, ep_axes=("model",), kv_seq_shard=False):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.sharding import ShardCtx
    return ShardCtx(mesh=make_mesh_for(dist.get_world_size(), model_par),
                    ep_axes=tuple(ep_axes), kv_seq_shard=kv_seq_shard)


def _seeded(cfg, dtype, dev, ctx=None):
    """``cfg``'s weights from seed 0 drawn on ``dev``: under a mesh, the
    rank's shard of the same logical weights."""
    from repro_torch.models import build_model
    return build_model(cfg, device=dev, dtype=dtype, ctx=ctx,
                       generator=torch.Generator(dev).manual_seed(0))


@torch.no_grad()
def _decode(model, tokens, steps, feed=None, src=None):
    """Prefill ``tokens`` [B, T] (numpy; over the source embeddings ``src``
    where given), then ``steps`` decode steps fed the greedy picks or
    ``feed`` [B, steps]. Returns the real vocab's logits of each call
    (float32, on the host) and the picks [B, steps + 1]. The prefill's
    caches are handed to a decode cache of ``steps`` more slots
    (``launch.shardings.decode_cache``: a window rolled into its ring;
    with ``kv_seq_shard`` every real KV head over the rank's slots, the
    Stage-3 hand-over of the sequence-sharded layout)."""
    from repro_torch.launch.shardings import decode_cache
    dev, vocab = model.device, model.cfg.vocab
    toks = torch.as_tensor(tokens, device=dev)
    batch = {"tokens": toks}
    if src is not None:
        batch["src_embeds"] = src
    lg, caches = model.prefill(batch)
    T = toks.shape[1]
    caches = decode_cache(caches, model, T, T + steps)
    outs, picks = [lg], [lg[:, 0, :vocab].argmax(-1)]
    for s in range(steps):
        tok = (picks[-1][:, None] if feed is None else
               torch.as_tensor(feed[:, s:s + 1], device=dev))
        lg, caches = model.decode_step(caches, tok, toks.shape[1] + s)
        outs.append(lg)
        picks.append(lg[:, 0, :vocab].argmax(-1))
    return ([o[..., :vocab].float().cpu() for o in outs],
            torch.stack(picks, 1).cpu())


def _serve_launches(merge=False):
    from repro_torch.kernels import attn_split as sp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    out = {"flash_attention": fa.flash_attention,
           "decode_attention": da.decode_attention}
    if merge:
        out["attn_merge"] = sp.attn_merge
    return out


def _rows(t, ctx):
    """A rank's rows joined over "data" (when the data axis split them)."""
    from repro_torch.models.sharding import all_gather
    return all_gather(t, ctx, ctx.batch_axes, 0)


def _peak(dev):
    """The device's peak memory in GB since the last ``_reset``."""
    dev = torch.device(dev)
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def _reset(dev):
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _sync(dev):
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ep_emulation(p, x, cfg, mode, mesh, ep_axes):
    """The expert-parallel MoE of ``mesh`` = (data, model) with EP over
    ``ep_axes``, in one process, on a layer's whole expert bank and the
    logical batch ``x`` (the routed experts only): the branch
    ``blocks.moe_apply`` takes on that mesh, each virtual shard's tokens
    (its batch rows, or all of them where ``data`` does not divide them,
    and its sequence block), the same capacities and drops, the shards'
    bodies run in turn with the ``all_to_all`` a transpose between them,
    and the ``psum`` a sum in rank order. Returns (y, pairs dropped)."""
    from repro_torch.models import blocks
    data, m = mesh
    sizes = {"data": data, "model": m}
    ep = math.prod(sizes[a] for a in ep_axes)
    B, T, D = x.shape
    E = p.w_in.shape[0]
    if ep == 1 or E % ep:
        return (blocks._moe_token_gather if mode == "decode"
                else blocks._moe_local)(p, x, cfg), 0
    E_loc = E // ep
    split_rows = B % data == 0
    nb = B // data if split_rows else B

    def rows(d):
        return x[d * nb:(d + 1) * nb] if split_rows else x

    def ep_index(d, j):
        return d * m + j if "data" in ep_axes else j

    def bank(i):
        return (p.w_in[i * E_loc:(i + 1) * E_loc],
                p.w_gate[i * E_loc:(i + 1) * E_loc],
                p.w_out[i * E_loc:(i + 1) * E_loc])

    groups = ([[(d, j) for d in range(data) for j in range(m)]]
              if "data" in ep_axes else
              [[(d, j) for j in range(m)] for d in range(data)])
    if T % m == 0:
        tl, out, dropped = T // m, {}, 0
        for group in groups:
            xs = {s: rows(s[0])[:, s[1] * tl:(s[1] + 1) * tl].reshape(-1, D)
                  for s in group}
            sends = {s: blocks._ep_send(xs[s], p.router, cfg, E_loc, ep)
                     for s in group}
            ys = [blocks._ep_experts(
                *bank(ep_index(*dst)),
                torch.stack([sends[s][0][k] for s in group]),
                torch.stack([sends[s][1][k] for s in group]))
                for k, dst in enumerate(group)]
            for i, s in enumerate(group):
                out[s] = blocks._ep_combine(torch.stack([y[i] for y in ys]),
                                            sends[s][2]).reshape(-1, tl, D)
                dropped = dropped + (sends[s][2][2]
                                     == sends[s][0].shape[1]).sum()
        ys_d = [torch.cat([out[(d, j)] for j in range(m)], 1)
                for d in range(data)]
        return (torch.cat(ys_d, 0) if split_rows else ys_d[0]), dropped
    outs = []
    for group in groups:
        xf = (x if "data" in ep_axes else rows(group[0][0])).reshape(-1, D)
        y = None
        for s in group:
            part = blocks._ep_partial(*bank(ep_index(*s)), p.router, xf, cfg,
                                      ep_index(*s) * E_loc, mode)
            y = part if y is None else y + part
        outs.append(y.reshape(-1, T, D))
    if "data" in ep_axes or not split_rows:
        return outs[0], 0
    return torch.cat(outs, 0), 0


class EPEmulation:
    """Within ``with``, the MoE layers of a model built with no mesh run
    ``ep_emulation`` of ``mesh`` (their shared experts as they are): the
    reference 6b holds a sharded run to. ``lm.moe_apply`` is patched, as
    ``RoutingLog`` patches ``blocks._route``."""

    def __init__(self, mesh, ep_axes):
        self.mesh, self.ep_axes = tuple(mesh), tuple(ep_axes)

    def __enter__(self):
        from repro_torch.models import lm
        self._inner = lm.moe_apply

        def moe_apply(p, x, *, cfg, mode, ctx=None):
            y = ep_emulation(p, x, cfg, mode, self.mesh, self.ep_axes)[0]
            return y if p.shared is None else y + p.shared(x, ctx)
        lm.moe_apply = moe_apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm
        lm.moe_apply = self._inner


class OrderedEPSum:
    """Within ``with``, the MoE's sum over the EP ranks (``blocks``'s
    ``reduce_from`` over ``ctx.ep_axes``) is an ``all_gather`` summed in
    rank order: every element in the same order, wherever it lies, where
    an ``all_reduce`` over more than two ranks sums each chunk of the
    tensor in an order of its own. 6b's witness of where the two data
    rows' copies of a prompt part."""

    def __enter__(self):
        from repro_torch.models import blocks
        from repro_torch.models.sharding import all_gather
        self._inner = inner = blocks.reduce_from

        def reduce_from(x, ctx, axes):
            if ctx is None or tuple(axes) != tuple(ctx.ep_axes):
                return inner(x, ctx, axes)
            parts = all_gather(x[None], ctx, axes, 0)
            y = parts[0]
            for part in parts[1:]:
                y = y + part
            return y
        blocks.reduce_from = reduce_from
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.reduce_from = self._inner


def p6_nccl_rank(rank, dev, cfg, prompts, steps):
    """6.0 on its rank: ``cfg`` (full-width smollm-360m) in bf16 on a
    (1, 1) mesh."""
    import torch.distributed as dist
    _p6_setup()
    ctx = _p6_ctx(1)
    model = _seeded(cfg, torch.bfloat16, dev, ctx)
    logits, picks = _decode(model, prompts, steps)
    return (dist.get_backend(), dict(ctx.mesh.shape),
            [x.numpy() for x in logits], picks.numpy())


def p6_smollm_rank(rank, dev, cfg, model_par, prompts, steps, grads, ckpt,
                   train_bt):
    """6a on its rank: ``cfg`` (full-width full-depth smollm-360m) in
    float32 on the mesh (prefill logits and greedy tokens of ``prompts``,
    the batch's rows split over "data"); with ``grads`` (B, T) the loss and
    every gradient of ``cfg`` at depth 2 in float32; with ``ckpt`` 3 bf16
    train steps at full depth, ``train_bt`` = (B, T), through the
    launcher's loop on the mesh, a checkpoint at step 2, then one warm step
    timed."""
    import dataclasses

    from repro_torch.launch import train as launch
    from repro_torch.launch.shardings import (gather_state, grad_sum_axes,
                                              model_splits, shard_batch)
    from repro_torch.training.trainer import sync_grads
    _p6_setup()
    ctx = _p6_ctx(model_par)
    out = {"rank": rank, "coords": {a: ctx.mesh.coord(a) for a in
                                    ctx.mesh.names}}
    wrappers = _serve_launches()
    for fn in wrappers.values():
        fn.launches = 0
    _reset(dev)
    model = _seeded(cfg, torch.float32, dev, ctx)
    local = shard_batch({"tokens": torch.from_numpy(prompts)}, ctx)["tokens"]
    t0 = time.perf_counter()
    logits, picks = _decode(model, local.numpy(), steps)
    _sync(dev)
    out["serve_s"] = time.perf_counter() - t0
    out["logits"] = [_rows(x, ctx).numpy() for x in logits]
    out["picks"] = _rows(picks, ctx).numpy()
    out["launches"] = {n: fn.launches for n, fn in wrappers.items()}
    out["peak_serve"] = _peak(dev)
    del model
    torch.cuda.empty_cache()
    if grads is not None:
        B, T = grads
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        model = _seeded(cfg2, torch.float32, dev, ctx)
        model.requires_grad_(True)
        batch = launch.synthetic_batch(cfg2, B, T, seed=0, step=0, device=dev)
        loss = model.loss(shard_batch(batch, ctx))
        loss.backward()
        shards = model_splits(model)
        g = sync_grads({n: p.grad for n, p in model.named_parameters()},
                       {n: grad_sum_axes(n, s, cfg2, ctx)
                        for n, s in shards.items()}, ctx)
        g = gather_state(g, shards, ctx)
        out["loss"] = float(loss.detach())
        if rank == 0:
            out["grads"] = {n: t.float().numpy() for n, t in g.items()}
        del model, g, loss
        torch.cuda.empty_cache()
    if ckpt:
        for fn in wrappers.values():
            fn.launches = 0
        from repro_torch.kernels import flash_attention as fa
        fa.flash_attention_bwd.launches = 0
        _reset(dev)
        B, T = train_bt
        t0 = time.perf_counter()
        state, losses, step_fn = launch.train_loop(
            dataclasses.replace(cfg, n_layers=P6_TRAIN_DEPTH), steps=3,
            batch=B, seq=T, **P6_TRAIN, ckpt_dir=ckpt,
            ckpt_every=2, log_every=0, device=dev, ctx=ctx)
        _sync(dev)
        out["train_s"] = time.perf_counter() - t0
        out["losses"] = losses
        out["train_launches"] = {"flash_attention": fa.flash_attention
                                 .launches, "flash_attention_bwd":
                                 fa.flash_attention_bwd.launches}
        # a warm step over step 0's batch again: its loss, before this
        # step's update, is that batch's after the 3 steps
        batch = shard_batch(launch.synthetic_batch(cfg, B, T, 0, 0,
                                                   device=dev), ctx)
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        _sync(dev)
        out["warm_ms"] = (time.perf_counter() - t0) * 1e3
        out["again"] = float(met["loss"])
        out["peak_train"] = _peak(dev)
        del state, step_fn
    return out


def _route_flips(rank_calls, emu_calls, group):
    """Tokens whose experts differ between a rank's router calls and the
    emulation's of the same tokens: the emulation routes each of the
    ``group`` virtual shards of an EP group in turn, the first being rank
    0's. Returns (calls compared, tokens flipped, the flipped tokens'
    margins on the rank, the rank's smallest margin)."""
    flips, margins = 0, []
    mine = emu_calls[::group]
    assert len(mine) == len(rank_calls), (len(mine), len(rank_calls))
    for (ri, _, rm), (ei, _) in zip(rank_calls, mine):
        ri, rm, ei = np.asarray(ri), np.asarray(rm), np.asarray(ei)
        n = min(ri.shape[0], ei.shape[0])
        differ = (ri[:n] != ei[:n]).any(-1)
        flips += int(differ.sum())
        margins += rm[:n][differ].tolist()
    return (len(rank_calls), flips, margins,
            min(c[1] for c in rank_calls))


def p6_moe_rank(rank, dev, full, model_par, ep_axes, check, feed, prompts,
                steps, witness):
    """6b on its rank: ``full`` (deepseek-moe-16b at full width) on the
    mesh with EP over ``ep_axes``. Depth 4 in float32: the prefill of
    ``check`` and the decode steps fed ``feed``, the router's choices
    logged; then full depth in bf16: each of ``prompts`` (B=1) prefilled
    and decoded greedily for ``steps`` steps, with the pairs dropped, the
    ``all_to_all`` bytes, the branches taken and the attention kernels'
    launches counted; then the first ``witness`` prompts again with the EP
    sums in rank order (``OrderedEPSum``), their logits kept."""
    import dataclasses
    _p6_setup()
    ctx = _p6_ctx(model_par, ep_axes)
    out = {"rank": rank}
    model = _seeded(dataclasses.replace(full, n_layers=4), torch.float32,
                    dev, ctx)
    with RoutingLog() as routes:
        logits, _ = _decode(model, check, feed.shape[1], feed=feed)
    out["check"] = [x.numpy() for x in logits]
    out["routes"] = ([(i.numpy(), m, mm.numpy()) for (i, m), mm in
                      zip(routes.calls, routes.margins)]
                     if rank == 0 else None)
    del model
    torch.cuda.empty_cache()
    ctx.stats.zero()
    wrappers = _serve_launches()
    for fn in wrappers.values():
        fn.launches = 0
    _reset(dev)
    model = _seeded(full, torch.bfloat16, dev, ctx)
    out["weights_gb"] = sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9
    t0, picks = time.perf_counter(), []
    for p in prompts:
        picks.append(_decode(model, np.asarray(p)[None], steps)[1].numpy())
    _sync(dev)
    st = ctx.stats
    out.update(serve_s=time.perf_counter() - t0, picks=picks,
               peak=_peak(dev), dropped=int(st.dropped), pairs=st.pairs,
               a2a_calls=st.a2a_calls, a2a_bytes=st.a2a_bytes,
               branches=dict(st.branches),
               launches={n: fn.launches for n, fn in wrappers.items()})
    with OrderedEPSum():
        out["witness"] = [_decode(model, np.asarray(p)[None], steps)
                          for p in prompts[:witness]]
    out["witness"] = [([x.numpy() for x in lg], pk.numpy())
                      for lg, pk in out["witness"]]
    return out


def _mesh_spawn(fn, world, args, tmp, name):
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    res = spawn(fn, world, args, init_method=f"file://{tmp}/{name}",
                device=P6_DEVICE, backend="gloo", timeout=900)
    return res, time.perf_counter() - t0


def _rel(got, want):
    return (max(float(np.abs(a - b).max()) for a, b in zip(got, want))
            / max(float(np.abs(b).max()) for b in want))


def phase_mesh_kernels():
    """6k: the attention kernels at the per-rank shapes of phase 6: a rank
    of full-width smollm-360m at model_par 2 holds 8 of the 16 padded
    query heads over all 5 KV heads (rank 0's map 0,0,0,1,1,1,2,2; rank
    1's 2,3,3,3,4,4,4,4), at 6a's training shape B=4 x 1024 (forward with
    the lse, backward) and at decode; a rank of deepseek-moe-16b holds 8
    of the 16 MHA heads with their KV heads (D=128). Each held to its plain
    version, with its time, bound and SDPA's, as phase 2's rows."""
    log("[6k] the attention kernels at a rank's heads (phase 6's shapes)")
    r0, r1 = [0, 0, 0, 1, 1, 1, 2, 2], [2, 3, 3, 3, 4, 4, 4, 4]
    bf = torch.bfloat16
    rows = {
        "1r0": flash_case("6a rank 0: smollm 8 over 5, B=4", bf, 1024, 1024,
                          64, B=4, H=8, kv_heads=5, kv_map=r0),
        "1r1": flash_case("6a rank 1: smollm 8 over 5, B=4", bf, 1024, 1024,
                          64, B=4, H=8, kv_heads=5, kv_map=r1),
        "1rm": flash_case("6b rank: deepseek-moe 8 over 8, D=128", bf, 256,
                          256, 128, H=8),
        "2r1": decode_case(bf, B=8, H=8, D=64, S=1024, kv_heads=5,
                           kv_map=r1, label="6a rank 1"),
        "2rm": decode_case(bf, B=8, H=8, D=128, S=1024, label="6b rank"),
    }
    rows["5r1"] = bwd_case("6a rank 1: smollm 8 over 5", 4, 1024, 1024, 64,
                           H=8, kv_map=r1, kv_heads=5)[0]
    return rows


#: the partial mode's output and lse are float32 on both sides: the
#: kernel's exp2/log2 approximations and summation order (as ``LSE_TOL``)
PARTIAL_TOL = LSE_TOL


def partial_case(label, dtype, B, H, D, S, m, kv_heads, kv_map, lengths, *,
                 int8=False, plain_reps=REPS):
    """The decode kernel's partial mode on a rank's slots: the ``S`` slots
    of row 2's inputs (``decode_case``'s generator, so the whole cache is
    that case's) cut into ``m`` blocks, each rank's partial (float32 output
    and base-2 lse over its block, lengths clamped to it) held to the plain
    partial, output row by row within ``PARTIAL_TOL`` of its largest value,
    lse within ``PARTIAL_TOL`` (the same rows -inf); rank 0's call timed,
    with SDPA over rank 0's slots as the yardstick (its output only; no
    library call writes the lse). Returns (the row, the inputs, every
    rank's partials)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.models.blocks import _KV_QSCALE, _kv_load, _kv_store
    g = torch.Generator(device="cuda").manual_seed(S + D)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, kv_heads, D, generator=g,
                        device="cuda").to(dtype) for _ in range(2))
    kv_scale = None
    if int8:
        k, v = (_kv_store(x, torch.int8) for x in (k, v))
        kv_scale = 1.0 / _KV_QSCALE
    kv_map = map_tensor(H, kv_heads, kv_map)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")[:B]
    n = S // m
    kw = dict(kv_map=kv_map, kv_scale=kv_scale, partial=True)
    parts, err = [], 0.0
    for r in range(m):
        kr, vr = k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n]
        lr = (lengths - r * n).clamp(0, n)
        o, lse = decode_attention(q, kr, vr, lr, **kw)
        po, plse = decode_attention_plain(q, kr, vr, lr, **kw)
        torch.cuda.synchronize()
        name = (f"decode_attention partial[{label} rank {r} of {m}: B={B},"
                f"S={n} of {S},D={D},H={H},Hk={kv_heads},{str(dtype)[6:]}"
                f"{', K/V int8' if int8 else ''}]")
        err = max(err, check_rows(name + " o", o, po, PARTIAL_TOL))
        same_inf = torch.equal(torch.isinf(lse), torch.isinf(plse))
        fin = torch.isfinite(plse)
        lerr = float((lse[fin] - plse[fin]).abs().max()) if fin.any() else 0
        ok = same_inf and lerr <= PARTIAL_TOL * max(
            1.0, float(plse[fin].abs().max()) if fin.any() else 1.0)
        log(f"  {name} lse: max_abs_err={lerr:.3e}, rows seeing no key "
            f"{int((~fin).sum())} (the same rows -inf: {same_inf}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name}: the partial's lse disagrees")
        parts.append((o, lse))
    l0 = (lengths).clamp(0, n)
    keys = int(l0.sum())
    es = k.element_size()
    flops = 4.0 * H * D * keys
    nbytes = (2 * keys * kv_heads * D * es + B * H * D * q.element_size()
              + B * H * (D + 1) * 4 + 4 * B)
    k0, v0 = k[:, :n], v[:, :n]
    mask = (torch.arange(n, device="cuda")[None] < l0[:, None])
    qt = q[:, :, None]
    kt, vt = (expanded(_kv_load(x, dtype), kv_map).transpose(1, 2)
              for x in (k0, v0))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None])
    row = _timed(f"partial {label} rank 0",
                 lambda: decode_attention(q, k0, v0, l0, **kw),
                 lambda: decode_attention_plain(q, k0, v0, l0, **kw), lib,
                 flops, nbytes, dtype, err, plain_reps=plain_reps)
    return row, (q, k, v, lengths, kv_map, kv_scale), parts


def merge_case(label, m, R, D, dtype):
    """``attn_merge`` (the combine kernel launched on its own) of ``m``
    ranks' float32 partials of ``R`` rows at ``D``, some ranks empty for a
    row and one row empty on every rank, into ``dtype``, against
    ``merge_partials``; timed (no library call computes it: null)."""
    from repro_torch.kernels.attn_split import attn_merge, merge_partials
    g = torch.Generator(device="cuda").manual_seed(m * R + D)
    o = torch.randn(m, R, D, generator=g, device="cuda")
    lse = torch.randn(m, R, generator=g, device="cuda") * 4
    lse[0, ::3] = -math.inf
    lse[:, 1] = -math.inf
    got = attn_merge(o, lse, dtype)
    again = attn_merge(o, lse, dtype)
    want = merge_partials(o, lse)
    torch.cuda.synchronize()
    name = f"attn_merge[{label}: m={m}, R={R}, D={D}, into {str(dtype)[6:]}]"
    err = check(name, got, want, TOL[dtype])
    if not (torch.equal(got, again) and torch.all(got[1] == 0)):
        raise SystemExit(f"{name}: two calls differ, or an empty row is "
                         "not 0")
    nbytes = m * R * (D + 1) * 4 + R * D * got.element_size()
    return _timed(name, lambda: attn_merge(o, lse, dtype),
                  lambda: merge_partials(o, lse).to(dtype), None,
                  6.0 * m * R * D, nbytes, torch.float32, err)


def phase_mesh_kernels_seq():
    """6k's rows of the sequence-sharded decode (6c): 2ss, smollm's 16
    over 5 at row 2's B=8 x 1024 (lengths 1, 1024, 0, 17, 128, 129, 512,
    1000: rows that see nothing in a slice), cut into 2 slices of 512, each
    slice's partial held to its plain version and the two merged by
    ``attn_merge`` held to row 2g's single call on the whole; 2q8s,
    qwen1.5-32b's 48 over 40 with int8 K/V, B=8, one rank's 16384 of 2q8's
    32768 slots; merge, ``attn_merge`` of 2 and 4 ranks' partials at 2ss's
    and 2q8s's rank shapes (B x H / m rows) and of deepseek-v3's latent
    (D = 512, 6c's B = 2 x 64 heads a rank). Returns the rows, and the
    merge row of the kernels line (2q8s's shape at m = 2, 6c's qwen
    step's)."""
    from repro_torch.kernels.attn_split import attn_merge
    from repro_torch.kernels.decode_attention import decode_attention
    log("[6k] the sequence-sharded decode's kernels: a rank's partial and "
        "the ranks' merge (6c's shapes)")
    bf = torch.bfloat16
    rows = {}
    rows["2ss"], (q, k, v, lengths, kv_map, _), parts = partial_case(
        "2ss smollm 16 over 5", bf, 8, 16, 64, 1024, 2, 5, None,
        [1, 1024, 0, 17, 128, 129, 512, 1000])
    got = attn_merge(torch.stack([o.reshape(-1, 64) for o, _ in parts]),
                     torch.stack([l.reshape(-1) for _, l in parts]),
                     bf).reshape(8, 16, 64)
    want = decode_attention(q, k, v, lengths, kv_map=kv_map)
    torch.cuda.synchronize()
    check("2ss: the 2 slices' partials merged vs row 2g's single call",
          got, want, TOL[bf])
    del q, k, v, parts, got, want
    rows["2q8s"] = partial_case(
        "2q8s qwen1.5-32b 48 over 40", bf, 8, 48, 128, QWEN_S, 2, 40,
        list(range(48)), QWEN_LENGTHS, int8=True, plain_reps=2)[0]
    gc_cuda()
    for m in (2, 4):
        rows[f"merge-2ss-m{m}"] = merge_case("2ss", m, 8 * 16 // m, 64, bf)
        rows[f"merge-2q8s-m{m}"] = merge_case("2q8s", m, 8 * 48 // m, 128,
                                              bf)
    rows["merge-mla"] = merge_case("6c deepseek-v3 latent", 2, 2 * 64, 512,
                                   torch.float32)
    return rows, rows["merge-2q8s-m2"]


def phase_mesh_kernels_tp():
    """6k's rows at 6r's per-rank shapes (tensor parallelism of RG-LRU and
    of the encoder-decoder at a model axis of 2): 4r, ``rglru_scan`` over a
    rank's 2048 of recurrentgemma-9b's 4096 channels at B=1 x 2112 (with
    an initial state, after CUDA-graph replays too); 1br, the windowed
    flash kernel at a rank's 8 of the 16 query heads over the one KV head,
    D=256, T=S=2112, window 2048; 2bs, the decode kernel's partial mode on
    a rank's 1024 of the ring's 2048 slots (B=8, D=256, 16 over 1; the ring
    full on most rows, two rows that see none of rank 1's slots); 2xs,
    seamless's cross-attention decode in the partial mode over a rank's 32
    of 64 source positions (B=8, D=64, 16 MHA heads, every length 32);
    merge-rg, ``attn_merge`` of the 2 ranks' partials at D=256 into a
    rank's 8 heads of 8 rows. Each held to its plain version and timed as
    phase 2's rows."""
    log("[6k] the kernels at 6r's per-rank shapes: RG-LRU's channel "
        "blocks, the windowed ring and the cross K/V split over 2 ranks")
    bf = torch.bfloat16
    mqa = [0] * 16
    ring = [2048, 2048, 1500, 2048, 1024, 2048, 17, 2048]
    return {
        "4r": rglru_case("6r rank: 2048 of 4096 channels", 1, 2112, 2048),
        "1br": flash_case("6r rank: recurrentgemma 8 over 1, D=256, window "
                          "2048", bf, 2112, 2112, 256, window=2048, H=8,
                          kv_heads=1, kv_map=[0] * 8),
        "2bs": partial_case("2bs recurrentgemma ring 16 over 1", bf, 8, 16,
                            256, 2048, 2, 1, mqa, ring)[0],
        "2xs": partial_case("2xs seamless cross 16 MHA", bf, 8, 16, 64, 64,
                            2, 16, list(range(16)), [64] * 8)[0],
        "merge-rg": merge_case("6r recurrentgemma ring", 2, 8 * 16 // 2,
                               256, bf),
    }


def phase_mesh_nccl(card):
    """6.0: NCCL at world size 1, mesh (1, 1), in a process of its own:
    full-width smollm-360m's bf16 prefill logits and greedy tokens bitwise
    the no-mesh model's (every collective is over one rank, so none
    runs)."""
    import tempfile
    cfg = _arch("smollm-360m")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 256))
    log(f"[6.0] mesh (1, 1) over NCCL, world size 1: full-width smollm-360m "
        f"(bf16, seed 0), prefill of 2 x 256 tokens, {P6_STEPS} greedy "
        "steps, against the model with no mesh")
    model = _seeded(cfg, torch.bfloat16, "cuda")
    want, want_picks = _decode(model, prompts, P6_STEPS)
    del model
    gc_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        from repro_torch.launch.mesh import spawn
        backend, shape, logits, picks = spawn(
            p6_nccl_rank, 1, (cfg, prompts, P6_STEPS),
            init_method=f"file://{tmp}/pg", device=P6_DEVICE,
            backend="nccl")[0]
    same = all(np.array_equal(a, b.numpy()) for a, b in zip(logits, want))
    log(f"  backend {backend}, mesh {shape}: logits of the prefill and "
        f"{P6_STEPS} steps bitwise equal: {same}; greedy tokens equal: "
        f"{np.array_equal(picks, want_picks.numpy())}")
    if not (same and np.array_equal(picks, want_picks.numpy())):
        raise SystemExit("6.0: the (1, 1) mesh differs from no mesh")


def phase_mesh_smollm(card):
    """6a: full-width full-depth smollm-360m on gloo at (1, 2) (16 padded
    query heads over 2 ranks, the 5 KV heads replicated, d_ff and the vocab
    split) and (2, 2): float32 prefill logits within 1e-3 of the largest
    logit of the single-rank card run and the greedy tokens equal; at
    (2, 2) also the loss and every logical gradient at phase 4t's depth
    and batch (1e-3 of each leaf's largest value), bf16 training at depth
    ``P6_TRAIN_DEPTH`` (B=8 x 1024, 3 steps, the loss falling, a checkpoint at step 2)
    and that checkpoint resumed at (1, 1) here, its step's loss the
    sharded run's to 1e-3."""
    import dataclasses
    import tempfile

    from repro_torch.launch import train as launch
    cfg = _arch("smollm-360m")
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (2, 256))
    log(f"[6a] mesh: full-width full-depth smollm-360m over gloo on one "
        f"card ({card}); every rank on {P6_DEVICE}, collectives through "
        "host memory")
    model = _seeded(cfg, torch.float32, "cuda")
    t0 = time.perf_counter()
    want, want_picks = _decode(model, prompts, P6_STEPS)
    log(f"  single rank, float32: prefill 2 x 256 + {P6_STEPS} steps "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    del model
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = _seeded(cfg2, torch.float32, "cuda")
    model.requires_grad_(True)
    loss = model.loss(launch.synthetic_batch(cfg2, 2, 256, seed=0, step=0))
    loss.backward()
    want_loss = float(loss.detach())
    want_grads = {n: p.grad.float().cpu() for n, p in
                  model.named_parameters()}
    del model, loss
    gc_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        for model_par, world in ((2, 2), (2, 4)):
            mesh = (world // model_par, model_par)
            last = world == 4
            res, wall = _mesh_spawn(p6_smollm_rank, world, (
                cfg, model_par, prompts, P6_STEPS,
                (2, 256) if last else None, f"{tmp}/ckpt" if last else "",
                (TRAIN_B, TRAIN_T)), tmp, f"pg{world}")
            r0 = res[0]
            rel = _rel(r0["logits"], [x.numpy() for x in want])
            same = np.array_equal(r0["picks"], want_picks.numpy())
            log(f"  {mesh}: {world} ranks in {wall:.1f} s; float32 prefill "
                f"+ {P6_STEPS} steps {r0['serve_s']:.3f} s on rank 0 "
                f"({card}, gloo on one card); logits relative difference "
                f"{rel:.3e} (tol 1e-3), greedy tokens equal: {same}; "
                f"launches a rank {[r['launches'] for r in res]}; peak "
                f"memory a rank {['%.2f GB' % r['peak_serve'] for r in res]}")
            if not (rel <= 1e-3 and same):
                raise SystemExit(f"6a: {mesh} disagrees with one rank")
            for r in res:
                assert all(v > 0 for v in r["launches"].values()), r
            if not last:
                continue
            worst, worst_name = 0.0, None
            for n, w in want_grads.items():
                top = float(w.abs().max())
                d = float(np.abs(r0["grads"][n] - w.numpy()).max()) / top
                if d > worst:
                    worst, worst_name = d, n
            rel_loss = abs(r0["loss"] - want_loss) / abs(want_loss)
            log(f"  {mesh} depth 2, float32, B=2 x 256: loss {r0['loss']:.6f}"
                f" vs {want_loss:.6f} (relative {rel_loss:.2e}, tol 1e-5); "
                f"{len(want_grads)} logical gradients, the largest "
                f"difference over the leaf's largest value {worst:.3e} "
                f"({worst_name}; tol 1e-3)")
            if not (rel_loss <= 1e-5 and worst <= 1e-3):
                raise SystemExit("6a: sharded gradients disagree")
            losses = r0["losses"]
            log(f"  {mesh} bf16 training, depth {P6_TRAIN_DEPTH}, B={TRAIN_B} x "
                f"{TRAIN_T}: losses {['%.4f' % x for x in losses]}, step 0's"
                f" batch again after them {r0['again']:.4f}; 3 steps in "
                f"{r0['train_s']:.2f} s (first included), a warm step "
                f"{r0['warm_ms']:.1f} ms ({card}, gloo through host memory,"
                f" 4 ranks sharing the card); train launches rank 0 "
                f"{r0['train_launches']}; peak memory a rank "
                f"{['%.2f GB' % r['peak_train'] for r in res]}")
            assert all(np.isfinite(losses)) and r0["again"] < losses[0], \
                (losses, r0["again"])
            assert all(v > 0 for v in r0["train_launches"].values())
            _, resumed, _ = launch.train_loop(
                dataclasses.replace(cfg, n_layers=P6_TRAIN_DEPTH), steps=3,
                batch=TRAIN_B, seq=TRAIN_T, **P6_TRAIN,
                ckpt_dir=f"{tmp}/ckpt", resume=True, log_every=0,
                device="cuda")
            rel3 = abs(resumed[0] - losses[2]) / abs(losses[2])
            log(f"  the step-2 checkpoint of {mesh} resumed at (1, 1): "
                f"step 3's loss {resumed[0]:.5f} vs the sharded run's "
                f"{losses[2]:.5f} (relative {rel3:.2e}, tol 1e-3)")
            if not rel3 <= 1e-3:
                raise SystemExit("6a: the resumed (1, 1) run disagrees")
            gc_cuda()


def phase_mesh_moe(card):
    """6b: full-width deepseek-moe-16b with classic EP at (1, 2) and 2D EP
    at (2, 2): at depth 4 in float32 the logits of a 256-token prefill (the
    dispatch branch) and 4 decode steps (the replicated one) held to the
    one-process emulation of the mesh's EP (``EPEmulation``) within 1e-3
    of the largest logit, the router's choices compared; then full depth
    in bf16, the first 4 of 3a's prompts each prefilled and decoded
    greedily for P6_STEPS steps (an odd prompt length takes the replicated
    branch), with the pairs dropped and the ``all_to_all`` bytes. At
    (2, 2) both data rows serve each prompt: the greedy tokens that differ
    between their copies are counted, and the first 4 prompts run again
    with the EP sums in rank order, where the two copies' logits must be
    bitwise equal."""
    import dataclasses
    import tempfile

    from repro_torch.launch.serve import make_requests
    full = _arch("deepseek-moe-16b")
    cfg4 = dataclasses.replace(full, n_layers=4)
    # the first 4 of 3a's 16 prompts (the fourth of odd length): every
    # prompt's decode step is ~100 collectives through host memory (8
    # prompts took 113-167 s of the smoke's time limit)
    prompts = [r.tokens for r in make_requests(full, 16, 200.0, seed=0,
                                               mean_prompt=256,
                                               max_new=8)][:P6_WITNESS]
    toks = np.random.default_rng(1).integers(0, full.vocab, (1, 260))
    check, feed = toks[:, :256], toks[:, 256:]
    log(f"[6b] mesh: deepseek-moe-16b at full width over gloo on one card "
        f"({card}); prompt lengths {[len(p) for p in prompts]}")
    with tempfile.TemporaryDirectory() as tmp:
        for model_par, world, axes in ((2, 2, ("model",)),
                                       (2, 4, ("data", "model"))):
            mesh = (world // model_par, model_par)
            ep = world if "data" in axes else model_par
            emu = _seeded(cfg4, torch.float32, "cuda")
            with EPEmulation(mesh, axes), RoutingLog() as routes:
                want, _ = _decode(emu, check, feed.shape[1], feed=feed)
            del emu
            gc_cuda()
            res, wall = _mesh_spawn(p6_moe_rank, world, (
                full, model_par, axes, check, feed, prompts, P6_STEPS,
                P6_WITNESS if mesh[0] > 1 else 0), tmp, f"pg{world}")
            r0 = res[0]
            rel = _rel(r0["check"], [x.numpy() for x in want])
            calls, flips, margins, smallest = _route_flips(
                r0["routes"], routes.calls, ep)
            log(f"  {mesh}, EP over {axes} ({full.n_experts // ep} experts "
                f"a rank), {world} ranks in {wall:.1f} s: depth 4 float32 "
                f"logits against the emulation, relative {rel:.3e} (tol "
                f"1e-3); rank 0's {calls} router calls, smallest top-"
                f"{full.top_k}/top-{full.top_k + 1} margin {smallest:.3e}, "
                f"tokens routed otherwise than the emulation: {flips} "
                f"(margins {['%.2e' % m for m in margins[:8]]})")
            if not rel <= 1e-3:
                raise SystemExit(f"6b: {mesh} disagrees with the emulation")
            dropped = sum(r["dropped"] for r in res)
            pairs = sum(r["pairs"] for r in res)
            per_layer = (r0["a2a_bytes"] / max(1, r0["a2a_calls"] // 3))
            log(f"  {mesh} full depth bf16: weights {r0['weights_gb']:.2f} "
                f"GB a rank; {len(prompts)} prompts + {P6_STEPS} greedy "
                f"steps each in {r0['serve_s']:.2f} s on rank 0 ({card}, gloo on one "
                f"card); branches rank 0 {r0['branches']}; pairs dropped "
                f"{dropped} of {pairs} dispatched; all_to_all sent by rank 0"
                f" {r0['a2a_bytes'] / 1e6:.2f} MB in {r0['a2a_calls']} "
                f"calls, {per_layer / 1e6:.3f} MB a dispatching MoE layer; "
                f"launches a rank {[r['launches'] for r in res]}; peak "
                f"memory a rank {['%.2f GB' % r['peak'] for r in res]}")
            for r in res:
                assert all(v > 0 for v in r["launches"].values()), r
                # a data row's model ranks hold the same all-reduced bits
                lead = res[r["rank"] // model_par * model_par]
                assert all(np.array_equal(a, b) for a, b in
                           zip(r["picks"], lead["picks"])), r["rank"]
            if mesh[0] > 1:
                # each data row serves the same prompt (B=1): the 4-rank
                # all-reduce sums its copies in other chunks, other orders
                other = res[model_par]
                differ = sum(int((a != b).sum())
                             for a, b in zip(r0["picks"], other["picks"]))
                same = [all(np.array_equal(a, b) for a, b in zip(la, lb))
                        and np.array_equal(pa, pb) for (la, pa), (lb, pb)
                        in zip(r0["witness"], other["witness"])]
                log(f"  {mesh}: greedy tokens that differ between the two "
                    f"data rows' copies of each prompt: {differ} of "
                    f"{sum(a.size for a in other['picks'])} (bf16); with "
                    f"the EP sums in rank order, the copies' logits of the "
                    f"first {P6_WITNESS} prompts ({P6_STEPS + 1} calls "
                    f"each) bitwise equal: {same}")
                if not all(same):
                    raise SystemExit(f"6b: {mesh}'s data rows disagree with "
                                     "the EP sums in rank order")
            assert set(r0["branches"]) == {"dispatch", "replicated"}, \
                r0["branches"]
            gc_cuda()


#: 6c's qwen1.5-32b decode cell: depth 64 -> 8 in bf16 over JAX's
#: decode_32k int8 cache, B=8 x 32768 slots sequence-sharded over 2 ranks
SEQ_QWEN_DEPTH = 8
#: 6c's bf16 logits, sharded vs one rank on the same weights and codes:
#: bf16 partial sums all-reduced and matmuls blocked otherwise, over 8
#: layers; a greedy pick may differ only where the reference's top two
#: logits are within twice this (of the largest logit) apart
SEQ_BF16_TOL = 5e-2


def _fill_codes(caches, blocks, m, seed):
    """Each token leaf of int8 ``caches`` filled with codes, layer by layer
    and slot block by slot block of an ``m``-rank split, from a generator
    seeded by (leaf, layer, block): ``blocks`` the blocks these leaves
    hold, in order (a rank's one, or all m for the whole cache), so a rank
    makes its own slots and the whole cache the same bytes. Nothing
    crosses processes."""
    idx = 0
    for seg in caches:
        for entry in seg:
            for name in sorted(entry["mix"]):
                t = entry["mix"][name]
                n = t.shape[2] // len(blocks)
                for c in range(t.shape[0]):
                    for j, r in enumerate(blocks):
                        g = torch.Generator(t.device).manual_seed(
                            seed + (idx * m + r))
                        t[c, :, j * n:(j + 1) * n] = torch.randint(
                            -127, 128, t[c, :, j * n:(j + 1) * n].shape,
                            generator=g, device=t.device, dtype=torch.int8)
                    idx += 1


def _qwen_step_inputs(cfg):
    """6c's int8 step: B=8 sequences at positions ``QWEN_LENGTHS - 1`` of
    a 32768-slot cache (after the step they hold ``QWEN_LENGTHS`` keys:
    one at slot 0 alone, several in both ranks' slots), a seeded token
    each."""
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (8, 1))
    return toks, np.asarray(QWEN_LENGTHS) - 1


@torch.no_grad()
def _qwen_int8_step(model, caches, toks, pos, timed=0):
    """One decode step over ``caches`` (the real vocab's float32 logits,
    numpy), then ``timed`` warm steps at the same positions timed (ms a
    step, host clock to a device sync)."""
    dev = model.device
    tok = torch.as_tensor(toks, device=dev)
    p = torch.as_tensor(pos, device=dev)
    lg, _ = model.decode_step(caches, tok, p)
    out = lg[:, 0, :model.cfg.vocab].float().cpu().numpy()
    ms = None
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            model.decode_step(caches, tok, p)
        _sync(dev)
        ms = (time.perf_counter() - t0) / timed * 1e3
    return out, ms


def p6_seq_dense_rank(rank, dev, cfg, prompts, steps):
    """6c's qwen1.5-32b on its rank at (1, 2) with ``kv_seq_shard``: full
    width at depth 2 in float32, a prefill of ``prompts`` and ``steps``
    greedy steps over the sequence-sharded cache; then depth
    ``SEQ_QWEN_DEPTH`` in bf16 over an int8 cache of B=8 x 32768 slots,
    the rank's 16384 filled by ``_fill_codes``, one step and 3 warm ones
    timed."""
    import dataclasses
    _p6_setup()
    ctx = _p6_ctx(2, kv_seq_shard=True)
    r = ctx.index("model")
    out = {"rank": rank}
    wrappers = _serve_launches(merge=True)
    for fn in wrappers.values():
        fn.launches = 0
    _reset(dev)
    model = _seeded(dataclasses.replace(cfg, n_layers=2), torch.float32,
                    dev, ctx)
    logits, picks = _decode(model, prompts, steps)
    out["logits"] = [x.numpy() for x in logits]
    out["picks"] = picks.numpy()
    out["launches"] = {n: fn.launches for n, fn in wrappers.items()}
    out["peak_f32"] = _peak(dev)
    del model
    torch.cuda.empty_cache()
    _reset(dev)
    model = _seeded(dataclasses.replace(cfg, n_layers=SEQ_QWEN_DEPTH),
                    torch.bfloat16, dev, ctx)
    caches = model.init_cache(8, QWEN_S, kv_dtype=torch.int8)
    out["cache_gb"] = sum(t.numel() for seg in caches for e in seg
                          for t in e["mix"].values()) / 1e9
    out["weights_gb"] = sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9
    _fill_codes(caches, [r], 2, seed=80)
    toks, pos = _qwen_step_inputs(cfg)
    _reset(dev)                 # the step's peak, not the fill's
    ctx.stats.zero()
    out["int8_logits"], _ = _qwen_int8_step(model, caches, toks, pos)
    out["seq_bytes"] = ctx.stats.seq_bytes
    _, out["warm_ms"] = _qwen_int8_step(model, caches, toks, pos, timed=3)
    out["peak_int8"] = _peak(dev)
    return out


def p6_seq_mla_rank(rank, dev, cfg2, prompts, steps, grads_bt, cfg4,
                    prompts4):
    """6c's deepseek-v3 on its rank at (1, 2) with TP of MLA: ``cfg2``
    (depth 2, the experts cut out) in float32, a prefill of ``prompts`` and
    ``steps`` greedy steps over the whole latent cache, then over the
    sequence-sharded one (the flag is read at each decode call); the loss
    and every gradient of ``grads_bt`` = (B, T), gathered to rank 0
    leaf by leaf, where the unsharded model on the same card then computes
    its own and the largest difference over each leaf's largest value is
    taken; then ``cfg4`` (depth 4, the MoE layer under classic EP) in bf16,
    ``prompts4`` prefilled and decoded both ways, a warm step timed."""
    _p6_setup()
    ctx = _p6_ctx(2)
    out = {"rank": rank}
    wrappers = _serve_launches(merge=True)
    model = _seeded(cfg2, torch.float32, dev, ctx)
    for seq in (False, True):
        ctx.kv_seq_shard = seq
        for fn in wrappers.values():
            fn.launches = 0
        ctx.stats.zero()
        logits, picks = _decode(model, prompts, steps)
        out[seq] = {"logits": [x.numpy() for x in logits],
                    "picks": picks.numpy(),
                    "launches": {n: fn.launches
                                 for n, fn in wrappers.items()},
                    "seq_bytes": ctx.stats.seq_bytes // steps}
    ctx.kv_seq_shard = False
    res, got, batch = _sharded_grads(dev, model, cfg2, *grads_bt)
    del model
    out.update(_vs_one_rank(dev, cfg2, batch, got, res))
    del got, batch
    torch.cuda.empty_cache()
    _reset(dev)
    model = _seeded(cfg4, torch.bfloat16, dev, ctx)
    out["weights4_gb"] = sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 1e9
    for seq in (False, True):
        ctx.kv_seq_shard = seq
        for fn in wrappers.values():
            fn.launches = 0
        ctx.stats.zero()
        _sync(dev)
        t0 = time.perf_counter()
        logits, picks = _decode(model, prompts4, steps)
        _sync(dev)
        out[("bf16", seq)] = {
            "logits": [x.numpy() for x in logits], "picks": picks.numpy(),
            "launches": {n: fn.launches for n, fn in wrappers.items()},
            "seq_bytes": ctx.stats.seq_bytes // steps,
            "serve_s": time.perf_counter() - t0}
    out["peak4"] = _peak(dev)
    return out


def _sharded_grads(dev, model, cfg, B, T, wrappers=()):
    """The loss and every gradient of the rank's shard ``model`` (float32,
    its mesh's ``ctx``) on the launcher's batch (B, T), the gradients
    summed as the trainer sums them (``sync_grads``) and gathered to rank 0
    leaf by leaf (``gather_to_root``: host copies, no whole model through
    a queue); ``model``'s gradients are freed. Returns (the loss, the
    launches of each of ``wrappers`` by name and the rank's peak memory;
    the gathered gradients, None off rank 0; the batch), for
    ``_vs_one_rank`` once the caller has freed ``model``."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.shardings import (gather_to_root, grad_sum_axes,
                                              model_splits, shard_batch)
    from repro_torch.training.trainer import sync_grads
    ctx = model.ctx
    model.requires_grad_(True)
    batch = launch.synthetic_batch(cfg, B, T, seed=0, step=0, device=dev)
    loss = model.loss(shard_batch(batch, ctx))
    loss.backward()
    shards = model_splits(model)
    grads = sync_grads({n: p.grad for n, p in model.named_parameters()},
                       {n: grad_sum_axes(n, sp, cfg, ctx)
                        for n, sp in shards.items()}, ctx)
    out = {"loss": float(loss.detach()), "peak": _peak(dev),
           "launches": {n: fn.launches for n, fn in dict(wrappers).items()}}
    got = {n: gather_to_root(g, shards[n], ctx) for n, g in grads.items()}
    del grads, loss
    model.requires_grad_(False)
    for p in model.parameters():
        p.grad = None
    return out, (got if ctx.mesh.rank == 0 else None), batch


def _vs_one_rank(dev, cfg, batch, got, out):
    """On rank 0 (``got`` the gathered gradients; nothing elsewhere), the
    unsharded model's loss and gradients on the same card and batch, and
    each leaf's largest difference over its largest value: ``out`` with
    the unsharded loss, the worst leaf and the count of gradients."""
    gc_cuda()
    if got is None:
        return out
    ref = _seeded(cfg, torch.float32, dev)
    ref.requires_grad_(True)
    loss = ref.loss(batch)
    loss.backward()
    out["ref_loss"] = float(loss.detach())
    worst, worst_name = 0.0, None
    for n, p in ref.named_parameters():
        want = p.grad.float()
        d = float((got[n].to(dev) - want).abs().max()) / float(
            want.abs().max())
        if d > worst:
            worst, worst_name = d, n
    out["grad_worst"], out["grad_worst_name"] = worst, worst_name
    out["n_grads"] = len(got)
    del ref, loss
    torch.cuda.empty_cache()
    return out


def _near_tie_flips(got_picks, want_logits, want_picks, tol):
    """Greedy picks that differ from the reference's where its top two
    logits are more than ``2 tol`` (of the largest logit) apart: each
    call's picks [B] against the reference's logits [B, 1, V]."""
    bad, differ = 0, 0
    for i, lg in enumerate(want_logits):
        lg = lg[:, -1]
        scale = float(np.abs(lg).max())
        for b in np.nonzero(got_picks[:, i] != want_picks[:, i])[0]:
            differ += 1
            if lg[b].max() - lg[b, got_picks[b, i]] > 2 * tol * scale:
                bad += 1
    return differ, bad


def phase_mesh_seq(card):
    """6c: the sequence-sharded decode (``kv_seq_shard``, JAX's decode
    layout) and TP of MLA at (1, 2), both ranks on the one card over gloo.
    qwen1.5-32b at full width: float32 at depth 2, a prefill of 2 x 256
    tokens and ``P6_STEPS`` greedy steps, logits within 1e-3 of the
    largest logit of the single-rank card run and tokens equal; bf16 at
    depth ``SEQ_QWEN_DEPTH`` over JAX's decode_32k int8 cache, B=8 x 32768
    slots, each rank's half made by ``_fill_codes`` and the single-rank
    reference's whole cache the same bytes, one step's logits within
    ``SEQ_BF16_TOL`` of the largest, a warm step timed, each rank's peak
    memory and bytes exchanged a step. deepseek-v3 at full width with TP
    of MLA: float32 at depth 2 with the experts cut out (as 4h), prefill +
    ``P6_STEPS`` steps with and without ``kv_seq_shard`` each within 1e-3
    of one rank and tokens equal, the loss and every logical gradient
    within 1e-3 of each leaf's largest value; then bf16 at 3h's depth 4
    (the MoE layer under classic EP), the two decodes held to each other
    at ``SEQ_BF16_TOL``, each rank's peak memory."""
    import dataclasses
    import tempfile
    qwen = _arch("qwen1.5-32b")
    prompts = np.random.default_rng(9).integers(0, qwen.vocab, (2, 256))
    log(f"[6c] mesh (1, 2), kv_seq_shard: the decode caches split by slots "
        f"over 2 ranks on one card ({card}), gloo through host memory")
    model = _seeded(dataclasses.replace(qwen, n_layers=2), torch.float32,
                    "cuda")
    want, want_picks = _decode(model, prompts, P6_STEPS)
    del model
    gc_cuda()
    model = _seeded(dataclasses.replace(qwen, n_layers=SEQ_QWEN_DEPTH),
                    torch.bfloat16, "cuda")
    caches = model.init_cache(8, QWEN_S, kv_dtype=torch.int8)
    _fill_codes(caches, [0, 1], 2, seed=80)
    toks, pos = _qwen_step_inputs(qwen)
    want8, one_ms = _qwen_int8_step(model, caches, toks, pos, timed=3)
    del model, caches
    gc_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        res, wall = _mesh_spawn(p6_seq_dense_rank, 2, (
            qwen, prompts, P6_STEPS), tmp, "pg-seq-dense")
    r0 = res[0]
    rel = _rel(r0["logits"], [x.numpy() for x in want])
    same = np.array_equal(r0["picks"], want_picks.numpy())
    log(f"  qwen1.5-32b depth 2 float32 (1, 2) seq-sharded: 2 ranks in "
        f"{wall:.1f} s; prefill 2 x 256 + {P6_STEPS} steps, logits relative "
        f"difference {rel:.3e} (tol 1e-3), greedy tokens equal: {same}; "
        f"launches a rank {[r['launches'] for r in res]}; peak memory a "
        f"rank {['%.2f GB' % r['peak_f32'] for r in res]}")
    if not (rel <= 1e-3 and same):
        raise SystemExit("6c: the sequence-sharded qwen decode disagrees "
                         "with one rank")
    for r in res:
        assert all(v > 0 for v in r["launches"].values()), r["launches"]
    w8 = want8
    rel8 = float(np.abs(r0["int8_logits"] - w8).max()) / float(
        np.abs(w8).max())
    picks8 = r0["int8_logits"].argmax(-1)[:, None]
    differ, bad = _near_tie_flips(picks8, [w8[:, None]],
                                  w8.argmax(-1)[:, None], SEQ_BF16_TOL)
    log(f"  qwen1.5-32b depth {SEQ_QWEN_DEPTH} bf16, int8 cache B=8 x "
        f"{QWEN_S} ({r0['cache_gb']:.2f} GB a rank, weights "
        f"{r0['weights_gb']:.2f} GB a rank): one step's logits vs one rank "
        f"on the same codes, relative {rel8:.3e} (tol {SEQ_BF16_TOL:g}), "
        f"argmax differing {differ} of 8 (past a near tie: {bad}); a warm "
        f"step {r0['warm_ms']:.2f} ms on rank 0 (one rank alone "
        f"{one_ms:.2f} ms; {card}, 2 ranks sharing the card, gloo through "
        f"host memory); sent a step by each rank "
        f"{[r['seq_bytes'] for r in res]} B (q gathered, partials); peak "
        f"memory a rank over the steps "
        f"{['%.2f GB' % r['peak_int8'] for r in res]}")
    if not (rel8 <= SEQ_BF16_TOL and bad == 0):
        raise SystemExit("6c: the sequence-sharded int8 step disagrees "
                         "with one rank")
    launches = {"attn_merge": r0["launches"]["attn_merge"]}
    ds = _arch("deepseek-v3-671b")
    cfg2 = dataclasses.replace(ds, n_layers=2, n_experts=0)
    cfg4 = dataclasses.replace(ds, n_layers=MLA_DEPTH)
    mprompts = np.random.default_rng(10).integers(0, ds.vocab, (2, 256))
    model = _seeded(cfg2, torch.float32, "cuda")
    wantm, wantm_picks = _decode(model, mprompts, P6_STEPS)
    del model
    gc_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        res, wall = _mesh_spawn(p6_seq_mla_rank, 2, (
            cfg2, mprompts, P6_STEPS, (2, 256), cfg4, mprompts[:, :128]),
            tmp, "pg-seq-mla")
    r0 = res[0]
    for seq in (False, True):
        got = r0[seq]
        rel = _rel(got["logits"], [x.numpy() for x in wantm])
        same = np.array_equal(got["picks"], wantm_picks.numpy())
        log(f"  deepseek-v3 depth 2 (experts cut) float32 (1, 2), TP of MLA"
            f"{', kv_seq_shard' if seq else ''}: logits relative "
            f"{rel:.3e} (tol 1e-3), greedy tokens equal: {same}; launches "
            f"a rank {[r[seq]['launches'] for r in res]}; sent a step by "
            f"rank 0 {got['seq_bytes']} B")
        if not (rel <= 1e-3 and same):
            raise SystemExit("6c: MLA under TP disagrees with one rank")
        if seq:
            assert all(r[seq]["launches"]["attn_merge"] > 0 for r in res)
    rel_loss = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    log(f"  deepseek-v3 depth 2 float32 (1, 2), B=2 x 256 with the MTP "
        f"term: loss {r0['loss']:.6f} vs {r0['ref_loss']:.6f} (relative "
        f"{rel_loss:.2e}, tol 1e-5); {r0['n_grads']} logical gradients, "
        f"the largest difference over the leaf's largest value "
        f"{r0['grad_worst']:.3e} ({r0['grad_worst_name']}; tol 1e-3)")
    if not (rel_loss <= 1e-5 and r0["grad_worst"] <= 1e-3):
        raise SystemExit("6c: MLA's sharded gradients disagree")
    a, b = r0[("bf16", False)], r0[("bf16", True)]
    rel4 = _rel(b["logits"], a["logits"])
    differ, bad = _near_tie_flips(b["picks"], a["logits"], a["picks"],
                                  SEQ_BF16_TOL)
    log(f"  deepseek-v3 depth {MLA_DEPTH} bf16 (1, 2), TP of MLA, classic "
        f"EP ({r0['weights4_gb']:.2f} GB of weights a rank): prefill 2 x "
        f"128 + {P6_STEPS} steps with kv_seq_shard vs without, logits "
        f"relative {rel4:.3e} (tol {SEQ_BF16_TOL:g}), greedy tokens "
        f"differing {differ} (past a near tie: {bad}); {b['serve_s']:.2f} s"
        f" vs {a['serve_s']:.2f} s on rank 0 ({card}, gloo on one card); "
        f"sent a step by rank 0 {b['seq_bytes']} B; launches a rank "
        f"{[r[('bf16', True)]['launches'] for r in res]}; peak memory a "
        f"rank {['%.2f GB' % r['peak4'] for r in res]}")
    if not (rel4 <= SEQ_BF16_TOL and bad == 0):
        raise SystemExit("6c: MLA's sequence-sharded bf16 decode disagrees")
    return launches


# ------------------------------------------------- phases 6z, 6m and 7
#: what phases measured that a later phase sets beside the dry run's
#: estimate (phase 7): the peak memory of phase 5's warm steps, in GB
MEASURED = {}

#: 6z(i)'s step: smollm-360m at depth 2 in float32, B x T, an lr small
#: enough that Adam's step of a gradient element near 0 (whose sign float32
#: sums in another order can flip) moves a weight by less than 1e-3 of its
#: leaf's largest value
Z3_B, Z3_T, Z3_LR = 4, 256, 1e-5
#: 6z(ii): starcoder2-3b's training batch, as phase 5s, at a depth cut (of
#: 30): a step moves every weight's gathers and float32 gradient sums
#: through gloo's host memory, ~100 s a step at full depth on the H100's
#: host, past the smoke's time budget
Z3_BIG_B, Z3_BIG_T, Z3_BIG_DEPTH = TRAIN_S_B, TRAIN_S_T, 10
#: 6m: mamba2-1.3b at depth 2, float32: prompts, greedy steps, the
#: gradients' batch
M2_PROMPTS, M2_STEPS, M2_BT = (2, 256), 4, (2, 256)


def _z3_ctx(model_par, zero3=True):
    import dataclasses
    return dataclasses.replace(_p6_ctx(model_par), zero3=zero3)


def _z3_step(cfg, ctx, dev, B, T, lr):
    """One float32 train step of ``cfg`` from seed 0's weights on the mesh
    of ``ctx`` (none: one rank) over the launcher's batch of step 0.
    Returns (loss, grad norm, the logical parameters after it on the host:
    rank 0's, None on the others)."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.shardings import (gather_to_root, model_splits,
                                              shard_batch)
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step)
    from repro_torch.training.trainer import TrainState
    model = _seeded(cfg, torch.float32, dev, ctx)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = AdamWConfig(lr=lr, warmup=1)
    state = TrainState(params, adamw_init(params, opt), 0)
    batch = launch.synthetic_batch(cfg, B, T, seed=0, step=0, device=dev)
    state, met = make_train_step(model, opt)(
        state, batch if ctx is None else shard_batch(batch, ctx))
    if ctx is None:
        after = {n: p.detach().cpu() for n, p in params.items()}
    else:
        shards = model_splits(model)
        after = {n: gather_to_root(p, shards[n], ctx)
                 for n, p in params.items()}
    return float(met["loss"]), float(met["grad_norm"]), after


def _resident(state):
    """A rank's bytes of parameters and optimizer moments."""
    return sum(t.numel() * t.element_size() for ts in (
        state.params, state.opt.m, state.opt.v) for t in ts.values())


def p6_zero3_rank(rank, dev, cfg, model_par, tmp, big, m2):
    """6z on its rank, ZeRO-3 over "data": (i) ``_z3_step`` of ``cfg``
    (smollm-360m at depth 2) on a (world / model_par, model_par) mesh; at
    model_par 1 also (iii) the launcher's loop in bf16 for 2 steps with a
    checkpoint at each, then a run resumed from step 1's checkpoint to
    step 2, each rank's shards held bitwise to the straight run's; (ii)
    ``big`` (starcoder2-3b at full width, a depth cut, bf16, remat): one
    step through the launcher's loop (its init included), timed, with the
    rank's peak memory and resident state bytes; and 6m's ranks on a
    (1, 2) mesh of the same group (``_mamba2_rank``, ``m2`` its config)."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch
    _p6_setup()
    ctx = _z3_ctx(model_par)
    out = {"rank": rank}
    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    out["loss"], out["gnorm"], after = _z3_step(cfg, ctx, dev, Z3_B, Z3_T,
                                                Z3_LR)
    out["launches"] = {"flash_attention": fa.flash_attention.launches,
                       "flash_attention_bwd":
                       fa.flash_attention_bwd.launches}
    if rank == 0:
        out["params"] = {n: t.float().numpy() for n, t in after.items()}
    del after
    gc_cuda()
    if model_par != 1:
        return out
    kw = dict(batch=Z3_B, seq=Z3_T, lr=1e-3, warmup=10, log_every=0,
              device=dev, ctx=ctx)
    straight, _, _ = launch.train_loop(cfg, steps=2, ckpt_dir=f"{tmp}/a",
                                       ckpt_every=1, **kw)
    if rank == 0:
        os.makedirs(f"{tmp}/b")
        shutil.copytree(f"{tmp}/a/step_00000001", f"{tmp}/b/step_00000001")
    dist.barrier()
    resumed, _, _ = launch.train_loop(cfg, steps=2, ckpt_dir=f"{tmp}/b",
                                      ckpt_every=0, resume=True, **kw)
    out["bitwise"] = all(torch.equal(a, b) for a, b in zip(
        straight.params.values(), resumed.params.values()))
    del straight, resumed
    gc_cuda()
    _reset(dev)
    _sync(dev)
    t0 = time.perf_counter()
    state, losses, _ = launch.train_loop(
        big, steps=1, batch=Z3_BIG_B, seq=Z3_BIG_T, remat=True, **P6_TRAIN,
        log_every=0, device=dev, ctx=ctx)
    _sync(dev)
    out["big_ms"] = (time.perf_counter() - t0) * 1e3
    out["big_losses"] = losses
    out["big_peak"] = _peak(dev)
    out["big_resident"] = _resident(state) / 1e9
    del state
    gc_cuda()
    out["m2"] = _mamba2_rank(rank, dev, *m2)
    return out


def dry_estimate(arch, B, T, mesh_shape, remat, cfg=None, **changes):
    """The dry run's (inputs, peak beyond them) of a rank's train step of
    ``arch`` (``cfg`` in place of its config: a depth cut) at B x T on a
    ``mesh_shape`` grid over ("data", "model"), in GB:
    ``launch.dryrun.run_cell`` on the meta device (``changes`` to the
    cell's ``ShardCtx``: ``zero3=False``)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import DryMesh
    cell = specs.Cell(arch=arch, shape=ShapeCell(f"train_{B}x{T}", T, B,
                                                 "train"), kind="train")
    rec = dryrun.run_cell(cell, DryMesh(mesh_shape), cfg, remat=remat,
                          **changes)
    if rec["status"] != "ok":
        raise SystemExit(f"7: the dry run of {arch} failed: {rec['error']}")
    return (rec["input_bytes_per_device"] / 1e9,
            rec["memory_analysis"]["temp_size_in_bytes"] / 1e9)


def _mamba2_rank(rank, dev, cfg, prompts):
    """6m on its rank: ``cfg`` (mamba2-1.3b at depth 2) in float32 on a
    (1, 2) mesh, its mixers whole on both ranks, its vocab split: prefill
    logits of ``prompts`` and ``M2_STEPS`` greedy decode steps, then the
    loss and every logical gradient of the launcher's batch ``M2_BT``,
    with the SSD kernels' launches and the mixers' gradient sums."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import train as launch
    from repro_torch.launch.shardings import (gather_state, grad_sum_axes,
                                              model_splits, shard_batch)
    from repro_torch.training.trainer import sync_grads
    ctx = _p6_ctx(2)
    ssd_scan.ssd_chunked.launches = ssd_scan.ssd_chunked_bwd.launches = 0
    model = _seeded(cfg, torch.float32, dev, ctx)
    logits, picks = _decode(model, prompts, M2_STEPS)
    model.requires_grad_(True)
    batch = launch.synthetic_batch(cfg, *M2_BT, seed=0, step=0, device=dev)
    loss = model.loss(shard_batch(batch, ctx))
    loss.backward()
    shards = model_splits(model)
    axes = {n: grad_sum_axes(n, s, cfg, ctx) for n, s in shards.items()}
    g = sync_grads({n: p.grad for n, p in model.named_parameters()}, axes,
                   ctx)
    g = gather_state(g, shards, ctx)
    out = {"loss": float(loss.detach()),
           "launches": {"ssd_chunked": ssd_scan.ssd_chunked.launches,
                        "ssd_chunked_bwd": ssd_scan.ssd_chunked_bwd.launches},
           "mixer_model_sums": [n for n, a in axes.items()
                                if ".mix." in n and "model" in a]}
    if rank == 0:
        out.update(logits=[x.numpy() for x in logits], picks=picks.numpy(),
                   grads={n: t.float().numpy() for n, t in g.items()})
    del model, g, loss
    gc_cuda()
    return out


def _mamba2_reference(cfg, prompts):
    """6m's single-rank run on the card: logits, greedy tokens, loss and
    gradients (on the host)."""
    from repro_torch.launch import train as launch
    model = _seeded(cfg, torch.float32, "cuda")
    logits, picks = _decode(model, prompts, M2_STEPS)
    model.requires_grad_(True)
    loss = model.loss(launch.synthetic_batch(cfg, *M2_BT, seed=0, step=0,
                                             device="cuda"))
    loss.backward()
    out = {"logits": logits, "picks": picks, "loss": float(loss.detach()),
           "grads": {n: p.grad.float().cpu() for n, p in
                     model.named_parameters()}}
    del model, loss
    gc_cuda()
    return out


def phase_mesh_zero3(card):
    """6z: ZeRO-3 (the JAX package's training layout) on gloo, the ranks
    sharing the one card: (i) smollm-360m at depth 2 in float32, one step at
    (2, 1) and (2, 2) with zero3 against one rank: the loss, the gradient
    norm and every parameter after the step within 1e-3 of the leaf's
    largest value; (iii) at (2, 1) a resume from a checkpoint bitwise equal
    to the straight run; (ii) starcoder2-3b at full width cut to
    ``Z3_BIG_DEPTH`` layers, bf16, B=2 x 1024, at (2, 1) with zero3 and
    remat for one step: its time, each rank's peak and resident state,
    beside the dry run's estimate for that rank, and the dry run's for a
    full-depth rank with and without zero3 (without it two full-depth ranks
    would not fit one card: the dry run shows it, no run of it is tried).
    The (2, 1) spawn also runs 6m's ranks (a (1, 2) mesh of the same 2
    processes, one spawn fewer). Returns rank 0's (ii) peak, the dry run's
    estimate of it, and 6m's results and reference."""
    import dataclasses
    import tempfile

    cfg = dataclasses.replace(_arch("smollm-360m"), n_layers=2)
    big = dataclasses.replace(_arch("starcoder2-3b"), n_layers=Z3_BIG_DEPTH)
    m2cfg = dataclasses.replace(_arch("mamba2-1.3b"), n_layers=2)
    m2prompts = np.random.default_rng(9).integers(0, m2cfg.vocab, M2_PROMPTS)
    log(f"[6z] ZeRO-3 over gloo on one card ({card}); ranks on "
        f"{P6_DEVICE}, collectives through host memory")
    loss, gnorm, want = _z3_step(cfg, None, "cuda", Z3_B, Z3_T, Z3_LR)
    gc_cuda()
    m2want = _mamba2_reference(m2cfg, m2prompts)
    est = {}
    for z in (True, False):
        inp, tmp = est[z] = dry_estimate("starcoder2-3b", Z3_BIG_B,
                                         Z3_BIG_T, (2, 1), True, zero3=z)
        log(f"  dry run, starcoder2-3b full depth, B={Z3_BIG_B} x "
            f"{Z3_BIG_T} at (2, 1), remat, {'with' if z else 'without'} "
            f"zero3: a rank's inputs {inp:.2f} GB + peak beyond them "
            f"{tmp:.2f} GB = {inp + tmp:.2f} GB; two ranks "
            f"{2 * (inp + tmp):.2f} GB of the card's 80")
    cut = dry_estimate("starcoder2-3b", Z3_BIG_B, Z3_BIG_T, (2, 1), True,
                       cfg=big)
    with tempfile.TemporaryDirectory() as tmp:
        for model_par, world in ((1, 2), (2, 4)):
            mesh = (world // model_par, model_par)
            res, wall = _mesh_spawn(p6_zero3_rank, world, (
                cfg, model_par, tmp, big, (m2cfg, m2prompts)), tmp,
                f"z3pg{world}")
            r0 = res[0]
            worst, worst_name = 0.0, None
            for n, w in want.items():
                top = max(float(w.abs().max()), 1e-30)
                d = float(np.abs(r0["params"][n] - w.float().numpy()).max())
                if d / top > worst:
                    worst, worst_name = d / top, n
            rl, rn = (abs(r0["loss"] - loss) / abs(loss),
                      abs(r0["gnorm"] - gnorm) / abs(gnorm))
            log(f"  {mesh} zero3: {world} ranks in {wall:.1f} s; depth 2 "
                f"float32 B={Z3_B} x {Z3_T}: loss {r0['loss']:.6f} vs "
                f"{loss:.6f} (relative {rl:.2e}), gradient norm "
                f"{r0['gnorm']:.6f} vs {gnorm:.6f} ({rn:.2e}), {len(want)} "
                f"parameters after the step, the largest difference over "
                f"the leaf's largest value {worst:.3e} ({worst_name}; tol "
                f"1e-3); launches a rank {[r['launches'] for r in res]}")
            if not (rl <= 1e-3 and rn <= 1e-3 and worst <= 1e-3):
                raise SystemExit(f"6z: {mesh} with zero3 disagrees with one "
                                 "rank")
            for r in res:
                assert all(v > 0 for v in r["launches"].values()), r
            if model_par != 1:
                continue
            m2 = [r["m2"] for r in res]
            bitwise = [r["bitwise"] for r in res]
            log(f"  {mesh} zero3, bf16 depth 2 through the launcher's loop:"
                f" resumed from step 1's checkpoint, every rank's shards at "
                f"step 2 bitwise equal to the straight run's: {bitwise}")
            if not all(bitwise):
                raise SystemExit("6z: the zero3 resume is not bitwise")
            big_peak = max(r["big_peak"] for r in res)
            log(f"  {mesh} zero3, starcoder2-3b full width, depth "
                f"{Z3_BIG_DEPTH}, bf16, remat, B={Z3_BIG_B} x {Z3_BIG_T}: "
                f"loss {['%.4f' % x for x in r0['big_losses']]}; one step "
                f"through the launcher's loop, its init included, "
                f"{r0['big_ms']:.1f} ms ({card}, gloo through host memory, "
                f"2 ranks on one card); peak a rank "
                f"{['%.2f GB' % r['big_peak'] for r in res]}; resident "
                f"parameters and moments a rank "
                f"{['%.2f GB' % r['big_resident'] for r in res]} (dry run: "
                f"{cut[0]:.2f} GB with the batch)")
            assert all(np.isfinite(r0["big_losses"])), r0["big_losses"]
    return big_peak, cut, m2, m2want


def phase_mesh_mamba2(card, res, want):
    """6m: mamba2-1.3b at full width, depth 2, float32, on a model axis of
    2 ranks (gloo on the one card; its ranks ran in 6z's spawn): prefill
    logits and greedy decode steps, the loss and every logical gradient
    against one rank, within 1e-3 of the largest value; ``ssd_chunked``
    and its backward launched on each rank; no "model" sum of a mixer's
    gradient."""
    log(f"[6m] mamba2-1.3b, full width, depth 2, float32, at (1, 2) over "
        f"gloo on one card ({card}): the mixers whole on both ranks, the "
        "vocab split")
    r0 = res[0]
    rel = _rel(r0["logits"], [x.numpy() for x in want["logits"]])
    same = np.array_equal(r0["picks"], want["picks"].numpy())
    worst, worst_name = 0.0, None
    for n, w in want["grads"].items():
        top = max(float(w.abs().max()), 1e-30)
        d = float(np.abs(r0["grads"][n] - w.numpy()).max()) / top
        if d > worst:
            worst, worst_name = d, n
    rel_loss = abs(r0["loss"] - want["loss"]) / abs(want["loss"])
    summed = sorted({n for r in res for n in r["mixer_model_sums"]})
    log(f"  (1, 2): logits relative difference {rel:.3e} (tol 1e-3), "
        f"greedy tokens equal: {same}; loss {r0['loss']:.6f} vs "
        f"{want['loss']:.6f} ({rel_loss:.2e}); {len(want['grads'])} "
        f"gradients, the largest difference over the leaf's largest value "
        f"{worst:.3e} ({worst_name}; tol 1e-3); launches a rank "
        f"{[r['launches'] for r in res]}; mixer gradients summed over "
        f"'model': {summed}")
    if not (rel <= 1e-3 and same and rel_loss <= 1e-3 and worst <= 1e-3):
        raise SystemExit("6m: mamba2 on a model axis disagrees with one rank")
    for r in res:
        assert all(v > 0 for v in r["launches"].values()), r
    assert not summed, summed


#: 6r: recurrentgemma-9b at full width cut to one (rec, rec, attn) unit,
#: float32, 2 prompts of 2112 tokens (past its 2048 window) and the
#: gradients' batch B=1 x 2112; seamless-m4t-medium at full width and
#: depth, float32, 2 prompts of 256 tokens over 64 source frames (the
#: launcher's frames for 256 tokens) and the gradients' batch B=1 x 256;
#: the greedy steps of both
TP_RG_DEPTH, TP_RG_T, TP_SM_T, TP_STEPS = 3, 2112, 256, 4


def _tp_wrappers():
    from repro_torch.kernels import attn_split as sp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    return {"flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "attn_merge": sp.attn_merge, "rglru_scan": rglru.rglru_scan,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rglru_scan_bwd": rglru.rglru_scan_bwd}


def p6_tp_rank(rank, dev, jobs):
    """6r on its rank at (1, 2): for each (label, config, prompts, source
    frames or None, gradients' (B, T)) of ``jobs``, the rank's shard in
    float32, a prefill and ``TP_STEPS`` greedy steps without and then with
    ``kv_seq_shard`` (the flag is read at each decode call), each run's
    launches of each kernel, bytes exchanged a step and peak memory; then
    the loss and every gradient against the unsharded model on rank 0
    (``_sharded_grads``, then ``_vs_one_rank`` once the shard is freed),
    with the backward kernels' launches."""
    _p6_setup()
    ctx = _p6_ctx(2)
    wrappers = _tp_wrappers()
    out = {"rank": rank}
    for label, cfg, prompts, src, bt in jobs:
        src = None if src is None else torch.as_tensor(src, device=dev)
        _reset(dev)
        model = _seeded(cfg, torch.float32, dev, ctx)
        for seq in (False, True):
            ctx.kv_seq_shard = seq
            for fn in wrappers.values():
                fn.launches = 0
            ctx.stats.zero()
            _sync(dev)
            t0 = time.perf_counter()
            logits, picks = _decode(model, prompts, TP_STEPS, src=src)
            _sync(dev)
            out[(label, seq)] = {
                "logits": [x.numpy() for x in logits],
                "picks": picks.numpy(), "serve_s": time.perf_counter() - t0,
                "launches": {n: fn.launches for n, fn in wrappers.items()},
                "seq_bytes": ctx.stats.seq_bytes // TP_STEPS,
                "peak": _peak(dev)}
        ctx.kv_seq_shard = False
        for fn in wrappers.values():
            fn.launches = 0
        _reset(dev)
        res, got, batch = _sharded_grads(dev, model, cfg, *bt, wrappers)
        del model
        out[(label, "grads")] = _vs_one_rank(dev, cfg, batch, got, res)
        del got, batch
        gc_cuda()
    return out


def phase_mesh_tp(card):
    """6r: tensor parallelism of RG-LRU and of the encoder-decoder at
    (1, 2), both ranks on the one card over gloo. recurrentgemma-9b at full
    width cut to ``TP_RG_DEPTH`` layers (one (rec, rec, attn) unit), float32:
    2 prompts of ``TP_RG_T`` tokens prefilled and ``TP_STEPS`` greedy steps,
    without ``kv_seq_shard`` (a rank's 2048 channels of each RG-LRU block,
    its 8 of the 16 query heads over the one KV head, the whole ring) and
    with it (the ring's 2048 slots split 1024 / 1024, the partials merged by
    ``attn_merge``), logits within 1e-3 of the largest logit of the
    single-rank card run and the tokens equal; the loss and every logical
    gradient at B=1 x ``TP_RG_T`` within 1e-3 (of each leaf's largest
    value). seamless-m4t-medium at full width and depth, float32, the same
    checks over 64 source frames (the cross K/V split 32 / 32 with the
    flag). Each rank's peak memory, launches of each kernel and bytes sent
    a step are printed; each run must launch the kernels of its path on
    both ranks."""
    import dataclasses
    import tempfile
    from repro_torch.launch.train import synthetic_batch
    rg = dataclasses.replace(_arch("recurrentgemma-9b"),
                             n_layers=TP_RG_DEPTH)
    sm = _arch("seamless-m4t-medium")
    rng = np.random.default_rng(26)
    rg_prompts = rng.integers(0, rg.vocab, (2, TP_RG_T))
    sm_prompts = rng.integers(0, sm.vocab, (2, TP_SM_T))
    sm_src = synthetic_batch(sm, 2, TP_SM_T, seed=1, step=0,
                             device="cpu")["src_embeds"].float().numpy()
    jobs = [("recurrentgemma-9b", rg, rg_prompts, None, (1, TP_RG_T)),
            ("seamless-m4t-medium", sm, sm_prompts, sm_src, (1, TP_SM_T))]
    log(f"[6r] mesh (1, 2): tensor parallelism of RG-LRU and of the "
        f"encoder-decoder, float32, 2 ranks on one card ({card}), gloo "
        f"through host memory: recurrentgemma-9b full width, depth "
        f"{TP_RG_DEPTH}, 2 x {TP_RG_T} tokens; seamless-m4t-medium full "
        f"width and depth, 2 x {TP_SM_T} tokens over {sm_src.shape[1]} "
        f"source frames; {TP_STEPS} greedy steps, without and with "
        "kv_seq_shard")
    want = {}
    for label, cfg, prompts, src, _ in jobs:
        model = _seeded(cfg, torch.float32, "cuda")
        want[label] = _decode(model, prompts, TP_STEPS,
                              src=None if src is None
                              else torch.as_tensor(src, device="cuda"))
        del model
        gc_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        res, wall = _mesh_spawn(p6_tp_rank, 2, (jobs,), tmp, "pg-tp")
    log(f"  2 ranks in {wall:.1f} s")
    r0 = res[0]
    expect = {
        ("recurrentgemma-9b", False): ("flash_attention", "decode_attention",
                                       "rglru_scan"),
        ("recurrentgemma-9b", True): ("flash_attention", "decode_attention",
                                      "rglru_scan", "attn_merge"),
        ("recurrentgemma-9b", "grads"): ("flash_attention",
                                         "flash_attention_bwd", "rglru_scan",
                                         "rglru_scan_bwd"),
        ("seamless-m4t-medium", False): ("flash_attention",
                                         "decode_attention"),
        ("seamless-m4t-medium", True): ("flash_attention",
                                        "decode_attention", "attn_merge"),
        ("seamless-m4t-medium", "grads"): ("flash_attention",
                                           "flash_attention_bwd")}
    for label, _, _, _, bt in jobs:
        wl, wp = want[label]
        for seq in (False, True):
            got = r0[(label, seq)]
            rel = _rel(got["logits"], [x.numpy() for x in wl])
            same = np.array_equal(got["picks"], wp.numpy())
            log(f"  {label} (1, 2){', kv_seq_shard' if seq else ''}: "
                f"logits relative difference {rel:.3e} (tol 1e-3), greedy "
                f"tokens equal: {same}; {got['serve_s']:.2f} s on rank 0; "
                f"sent a step by each rank "
                f"{[r[(label, seq)]['seq_bytes'] for r in res]} B; peak "
                f"memory a rank "
                f"{['%.2f GB' % r[(label, seq)]['peak'] for r in res]}; "
                f"launches a rank "
                f"{[r[(label, seq)]['launches'] for r in res]}")
            if not (rel <= 1e-3 and same):
                raise SystemExit(f"6r: {label} under TP disagrees with one "
                                 "rank")
        g = r0[(label, "grads")]
        rel_loss = abs(g["loss"] - g["ref_loss"]) / abs(g["ref_loss"])
        log(f"  {label} (1, 2), B={bt[0]} x {bt[1]}: loss {g['loss']:.6f} "
            f"vs {g['ref_loss']:.6f} (relative {rel_loss:.2e}, tol 1e-3); "
            f"{g['n_grads']} logical gradients, the largest difference "
            f"over the leaf's largest value {g['grad_worst']:.3e} "
            f"({g['grad_worst_name']}; tol 1e-3); peak memory a rank "
            f"through its backward "
            f"{['%.2f GB' % r[(label, 'grads')]['peak'] for r in res]}; "
            f"launches a rank "
            f"{[r[(label, 'grads')]['launches'] for r in res]}")
        if not (rel_loss <= 1e-3 and g["grad_worst"] <= 1e-3):
            raise SystemExit(f"6r: {label}'s sharded gradients disagree")
        for key, names in expect.items():
            if key[0] != label:
                continue
            for r in res:
                missing = [n for n in names if not r[key]["launches"][n]]
                if missing:
                    raise SystemExit(f"6r: {key} launched no {missing} on "
                                     f"rank {r['rank']}")


def phase_dry_vs_card(card, z3_peak, z3_est):
    """7: the dry run's estimate of a rank's peak (its inputs plus the
    most it holds beyond them, on the meta device) beside the card's
    ``max_memory_allocated``: phase 5's cell (smollm-360m, bf16, B=8 x
    1024, one rank, no remat) and 6z(ii)'s rank (starcoder2-3b at (2, 1),
    depth ``Z3_BIG_DEPTH``, with zero3 and remat)."""
    inp, tmp = dry_estimate("smollm-360m", TRAIN_B, TRAIN_T, (1, 1), False)
    rows = [("5: smollm-360m B=8 x 1024, one rank", inp + tmp,
             MEASURED.get("5")),
            (f"6z(ii): starcoder2-3b depth {Z3_BIG_DEPTH}, B=2 x 1024, "
             "(2, 1), zero3, a rank", sum(z3_est), z3_peak)]
    log(f"[7] the dry run against the card ({card})")
    for label, est, got in rows:
        if got is None:
            log(f"  {label}: dry run {est:.2f} GB; the card's peak not "
                "measured in this run")
            continue
        log(f"  {label}: dry run {est:.2f} GB, the card's peak {got:.2f} GB"
            f", card / dry run {got / est:.3f}")


# ------------------------------------------------------------------ phase 8
def serve_profile(cfg, kv_dtype_bytes=2):
    """The ``StageProfile`` a default ``DisaggServer`` builds for ``cfg``:
    the modeled clock of the port's server (``DisaggConfig.hw`` is
    ``H100``; one GPU a unit)."""
    from repro_torch.core.stages import (GroupPlan, ParallelismSpec,
                                         StageProfile)
    from repro_torch.serving import DisaggConfig
    dc = DisaggConfig(kv_dtype_bytes=kv_dtype_bytes)
    return StageProfile(
        model=cfg, hw=dc.hw, par=ParallelismSpec(mode="ep",
                                                 ep=dc.gpus_per_unit),
        plan=GroupPlan.build(cfg.n_layers, min(dc.layer_groups,
                                               cfg.n_layers)),
        kv_dtype_bytes=kv_dtype_bytes, act_dtype_bytes=2,
        gpus_per_server=dc.gpus_per_unit)


def prefill_modeled(cfg):
    """The modeled work and seconds of ``prefill_clock``'s prompts on the
    server's clock: the FLOPs its groups' times stand for, and their sum."""
    from repro_torch.core.stages import PrefillItem
    prof = serve_profile(cfg)
    items = [PrefillItem(rid=i, arrival=0.0, n_tokens=CLOCK_TOKENS)
             for i in range(CLOCK_PROMPTS)]
    t = sum(prof.group_compute_time(items, g) for g in range(len(prof.plan)))
    return t * prof.par.gpus * prof.hw.flops * prof.hw.mfu, t


def decode_row_model(dtype, kw, *, cap, sms):
    """One phase-2 decode row on the cost model: (the cost model's bytes
    summed per sequence over the row's lengths, the kernel's traffic by
    ``decode_attention_traffic``). ``cap(D)`` gives the kernel's heads a
    block."""
    import inspect

    from repro_torch.kernels.decode_attention import (decode_attention_cost,
                                                      decode_attention_traffic)
    a = inspect.signature(decode_case).bind(dtype, **kw)
    a.apply_defaults()
    B, H, D, S = (a.arguments[k] for k in ("B", "H", "D", "S"))
    Hk = a.arguments["kv_heads"] or H
    lengths = (a.arguments["lengths"] or row2_lengths(S))[:B]
    qb = torch.finfo(dtype).bits // 8
    kvb = 1 if a.arguments["int8"] else qb
    cost = sum(decode_attention_cost(1, Hk, D, n, dtype_bytes=kvb)[1]
               for n in lengths)
    traffic = decode_attention_traffic(
        B, H, Hk, D, S, lengths, cap=cap(D), sms=sms, dtype_bytes=kvb,
        q_bytes=qb, kv_map=map_list(H, Hk, a.arguments["kv_map"]))
    return cost, traffic


def phase_clock(card, prefills, decode_rows, steps, *, cap=None, sms=None):
    """8: the modeled clock (``StageProfile`` on the ``H100`` profile, the
    port's server's) against the card. Prefill: the measured share of
    peak, modeled FLOPs over 989 TFLOP/s times ``prefill_clock``'s median,
    for each served dense model (``prefills``: arch -> its host and device
    seconds), each in (0, 1], and the share over the device's busy time;
    the modeled time at ``H100.mfu`` beside the measured.
    Decode: each phase-2 row's cost-model bytes at ``hbm_bw * hbm_eff``
    against its graph time, with the share of the split-KV partials in the
    kernel's traffic; 3g's steps (``steps``) against ``decode_step_time``
    and ``decode_step_roofline`` of qwen1.5-32b at its depth. ``cap`` and
    ``sms`` default to the built kernel's and the card's."""
    import dataclasses

    from repro_torch.kernels.attn_split import sm_count
    from repro_torch.kernels.decode_attention import _cap
    from repro_torch.simcluster.hw import H100
    cap = cap or _cap
    sms = sms or sm_count(torch.device("cuda"))
    log(f"[8] the modeled clock against the card ({card}): H100 profile "
        f"flops {H100.flops:.4g}, mfu {H100.mfu}, hbm_bw {H100.hbm_bw:.4g} "
        f"B/s, hbm_eff {H100.hbm_eff}")
    log(f"  prefill, {CLOCK_PROMPTS} x {CLOCK_TOKENS} tokens through "
        "ServingEngine.prefill, no reuse:")
    for arch, (t, busy) in prefills.items():
        flops, modeled = prefill_modeled(_arch(arch))
        mfu = flops / (989e12 * t)
        log(f"    {arch}: modeled {flops / 1e12:.3f} TFLOP; measured "
            f"{t:.4f} s -> mfu_measured {mfu:.4f} (device busy {busy:.4f} s "
            f"-> {flops / (989e12 * busy):.4f}); modeled at mfu {H100.mfu}: "
            f"{modeled:.4f} s ({modeled / t - 1:+.3f})")
        if not 0.0 < mfu <= 1.0:
            raise SystemExit(f"{arch}: a measured share of peak of {mfu:.4f}"
                             ": the modeled work or the timing is wrong")
    bw = H100.hbm_bw * H100.hbm_eff
    log(f"  decode attention, phase 2's rows: the cost model's bytes (per "
        f"sequence, over the row's lengths) at {bw / 1e12:.4g} TB/s against "
        "the graph time; the kernel's split-KV partials' share of its "
        "traffic (decode_attention_traffic)")
    for row, dtype, kw, r in decode_rows:
        cost, tr = decode_row_model(dtype, kw, cap=cap, sms=sms)
        total = tr["kv"] + tr["q"] + tr["out"] + tr["partials"]
        modeled, ms = cost / bw * 1e3, r["ms"]
        kv = " K/V int8" if kw.get("int8") else ""
        log(f"    {row} {str(dtype)[6:]}{kv}: cost {cost / 1e6:.4f} MB, "
            f"modeled {modeled:.5f} ms, measured {ms:.5f} ms, model error "
            f"{modeled / ms - 1:+.3f}; traffic {total / 1e6:.4f} MB, "
            f"{tr['n_split']} chunks, partials {tr['partials'] / total:.4f} "
            "of it")
    cfg = dataclasses.replace(_arch("qwen1.5-32b"), n_layers=QWEN_DEPTH)
    log(f"  decode step, qwen1.5-32b at depth {QWEN_DEPTH} (3g):")
    for kvb, B, ctx, t, dev in steps:
        prof = serve_profile(cfg, kv_dtype_bytes=kvb)
        a = prof.decode_step_time(B, ctx)
        rl = prof.decode_step_roofline(B, ctx)
        log(f"    {'int8' if kvb == 1 else 'bf16'} K/V, B={B}, mean keys "
            f"{ctx:.1f}: decode_step_time {a * 1e3:.3f} ms, "
            f"decode_step_roofline {rl * 1e3:.3f} ms; measured host "
            f"{t * 1e3:.3f} ms, device {dev:.3f} ms; model error "
            f"{a / t - 1:+.3f} (host), {a * 1e3 / dev - 1:+.3f} (device)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import gc

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log("[1] environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {name}: {line.strip()}")

    def run_phase(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        gc.collect()                      # the phase's models go here
        torch.cuda.empty_cache()
        log(f"  phase {label} took {time.perf_counter() - t:.1f} s")
        return out

    if sys.argv[1:] == ["--mesh-only"]:
        # phase 6 alone (after the build), to rehearse it on the card; the
        # smoke's result lines come only from a run of every phase
        run_phase("6k", phase_mesh_kernels)
        run_phase("6k", phase_mesh_kernels_seq)
        for label, fn in (("6.0", phase_mesh_nccl), ("6a", phase_mesh_smollm),
                          ("6b", phase_mesh_moe), ("6c", phase_mesh_seq)):
            run_phase(label, fn, card)
        log(f"  mesh phases passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    main_cases, decode_rows = run_phase("2", phase_kernels)
    # phase 8's prefill times: 3a, 3e, 3f and 3i time ServingEngine.prefill
    # on their full-depth models
    prefills = {}
    launches, prefills["smollm-360m"] = run_phase("3a", phase_serve_smollm)
    launches.update(run_phase("3b", phase_serve_mamba2))
    # the hybrid path launches both attention kernels too: the kernels
    # line keeps 3a's counts for them and reads rglru_scan's from 3c
    hybrid = run_phase("3c", phase_serve_hybrid)
    launches["rglru_scan"] = hybrid["rglru_scan"]
    # 3d-3g launch both attention kernels at head dim 128; the kernels line
    # keeps 3a's counts for them
    run_phase("3d", phase_serve_moe)
    # at 3a's 200 requests/s the modeled prefill of an 8 B model outlasts
    # the gaps, so no prefix is registered before the requests that share
    # it are routed (0 reused); at 100 a follow-up resumes a 32-token
    # prefix, as in 3a and 3f (the modeled clock reads the config only:
    # tests/test_torch_dense.py checks both streams on the CPU)
    _, prefills["minitron-8b"] = run_phase("3e", phase_serve_dense,
                                           "minitron-8b", "3e", rps=100.0)
    _, prefills["starcoder2-3b"] = run_phase("3f", phase_serve_dense,
                                             "starcoder2-3b", "3f")
    qwen = run_phase("3g", phase_qwen_int8)
    # the last three families: deepseek-v3 at full width cut to depth 4
    # (53.4 GB in bf16; depth 5 would be 76.5 GB), qwen2-vl-7b at full
    # width and depth on 3a's stream at 100 requests/s (at 200 its modeled
    # prefills outlast the gaps, as minitron-8b's), then one prefill from
    # input embeddings; seamless-m4t-medium at full width and depth
    run_phase("3h", phase_serve_mla)
    _, prefills["qwen2-vl-7b"] = run_phase("3i", phase_serve_dense,
                                           "qwen2-vl-7b", "3i", rps=100.0,
                                           embeds=True)
    run_phase("3j", phase_serve_encdec)
    run_phase("4a", phase_whole_model, "smollm-360m")
    run_phase("4b", phase_whole_model, "mamba2-1.3b")
    # float32 at full depth would be 38.5 GB on each side: depth 5 is one
    # (rec, rec, attn) unit and the (rec, rec) tail; 2112 tokens crop the
    # 2048 window, so the decode steps run through the rolled ring
    run_phase("4c", phase_whole_model, "recurrentgemma-9b", n_layers=5,
              n=2112)
    # float32 at full depth would be 65.5 GB on each side: depth 4 is the
    # dense first layer and 3 MoE layers, ~8.8 GB a side
    run_phase("4d", phase_whole_model, "deepseek-moe-16b", n_layers=4)
    # the dense family at cut depth, float32 on each side: minitron-8b at 2
    # layers (its untied 256000-row embed and unembed are 8.4 GB of the
    # 10.3), starcoder2-3b at 4, qwen1.5-32b at 2 (10.6 GB) with int8
    # caches on both sides
    run_phase("4e", phase_whole_model, "minitron-8b", n_layers=2)
    run_phase("4f", phase_whole_model, "starcoder2-3b", n_layers=4)
    run_phase("4g", phase_whole_model, "qwen1.5-32b", n_layers=2, int8=True)
    # 4h: MLA at full width with the experts cut out (n_experts 0: both
    # layers and the MTP layer dense), depth 2, 3.71 B parameters, 14.8 GB
    # a side in float32 (at depth 4 with the experts, 107 GB); 4i:
    # qwen2-vl-7b at depth 2 from input embeddings; 4j: seamless at 2
    # encoder + 2 decoder layers with 64 source frames
    run_phase("4h", phase_whole_model, "deepseek-v3-671b", n_layers=2,
              changes={"n_experts": 0})
    run_phase("4i", phase_whole_model, "qwen2-vl-7b", n_layers=2,
              embeds=True)
    run_phase("4j", phase_whole_model, "seamless-m4t-medium", n_layers=2,
              changes={"enc_layers": 2}, src_len=SEAMLESS_SRC)
    # training: the gradients card vs CPU, then full-width full-depth
    # smollm-360m's train steps (the backward kernel's main path; its
    # launches, and the forward's, are this run's)
    # the kernels line keeps 3a's count for the forward and reads the
    # backward's from phase 5
    run_phase("4t", phase_train_grads, "smollm-360m", n_layers=2, B=2,
              T=256, expect={"flash_attention": 2, "flash_attention_bwd": 2})
    # the scans' gradients: full-width mamba2-1.3b at depth 2 (the SSD
    # forward and backward) and recurrentgemma-9b at depth 3, one (rec,
    # rec, attn) unit (both RG-LRU kernels and both attention kernels at
    # head dim 256)
    run_phase("4t", phase_train_grads, "mamba2-1.3b", n_layers=2, B=2,
              T=256, expect={"ssd_chunked": 2, "ssd_chunked_bwd": 2})
    run_phase("4t", phase_train_grads, "recurrentgemma-9b", n_layers=3, B=1,
              T=128, expect={"rglru_scan": 2, "rglru_scan_bwd": 2,
                             "flash_attention": 1, "flash_attention_bwd": 1})
    launches["flash_attention_bwd"] = run_phase(
        "5", phase_train)["flash_attention_bwd"]
    # starcoder2-3b's train step: the backward at 32 query heads over 2 KV
    # heads, split over blocks (row 5s; the kernels line keeps phase 5's
    # count, the main path's)
    run_phase("5s", phase_train_starcoder2)
    # the scans' backward on their main paths: full-width full-depth
    # mamba2-1.3b (5m) and recurrentgemma-9b at a depth cut (5r); the
    # kernels line reads each backward's launches from its phase
    launches["ssd_chunked_bwd"] = run_phase(
        "5m", phase_train_mamba2)["ssd_chunked_bwd"]
    launches["rglru_scan_bwd"] = run_phase(
        "5r", phase_train_hybrid)["rglru_scan_bwd"]
    # the mesh: the kernels at a rank's heads, then ranks spawned on the
    # one card, after the card is freed
    run_phase("6k", phase_mesh_kernels)
    _, main_cases["attn_merge"] = run_phase("6k", phase_mesh_kernels_seq)
    run_phase("6.0", phase_mesh_nccl, card)
    run_phase("6a", phase_mesh_smollm, card)
    run_phase("6b", phase_mesh_moe, card)
    # the sequence-sharded decode: the merge kernel's main path (its
    # launches are 6c's qwen run's, rank 0's)
    launches.update(run_phase("6c", phase_mesh_seq, card))
    # the training layout (ZeRO-3), mamba2 on a model axis, and the dry
    # run's memory estimate against the card's
    z3_peak, z3_est, m2, m2want = run_phase("6z", phase_mesh_zero3, card)
    run_phase("6m", phase_mesh_mamba2, card, m2, m2want)
    # tensor parallelism of RG-LRU and of the encoder-decoder: the kernels
    # at a rank's shapes, then both families at (1, 2)
    run_phase("6k", phase_mesh_kernels_tp)
    run_phase("6r", phase_mesh_tp, card)
    run_phase("7", phase_dry_vs_card, card, z3_peak, z3_est)
    run_phase("8", phase_clock, card, prefills, decode_rows, qwen["steps"])

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:110"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_xla.py:104"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:110"),
               # no TPU kernel: XLA merges the softmax across the shards
               # of the JAX package's sequence-sharded cache
               "attn_merge": (
                   "src/repro_torch/csrc/attn_merge.cu",
                   "XLA's cross-shard softmax of the sequence-sharded "
                   "cache, src/repro/models/blocks.py:162 (attn_apply), "
                   ":302 (mla_apply)"),
               "ssd_chunked": ("src/repro_torch/csrc/ssd_scan.cu",
                               "src/repro/kernels/ssd_scan.py:85"),
               "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                              "src/repro/kernels/rglru.py:57"),
               # no TPU kernel: JAX differentiates its oracles off the TPU
               "ssd_chunked_bwd": (
                   "src/repro_torch/csrc/ssd_scan_bwd.cu",
                   "autodiff of src/repro/kernels/ref.py:168 (ssd_dual), "
                   "run off the TPU by src/repro/kernels/ops.py:78"),
               "rglru_scan_bwd": (
                   "src/repro_torch/csrc/rglru_scan_bwd.cu",
                   "autodiff of src/repro/kernels/ref.py:237 (rglru_ref), "
                   "run off the TPU by src/repro/kernels/ops.py:91")}
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], **main_cases[n]}
               for n, (src, rep) in sources.items()]
    log(f"  all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
