"""Smoke run of the PyTorch port on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before a result is printed:
  1. environment — the card's name and power limit, then the build of every
     CUDA kernel from ``src/repro_torch/csrc`` (one nvcc each, in parallel);
  2. kernels — each Hopper kernel against its plain PyTorch version on the
     card, with its time, the plain version's, one PyTorch library call's
     (``scaled_dot_product_attention``, timed here as a yardstick only) and
     the bound (the larger of the flop time at the dtype's peak and the
     byte time at 3.35 TB/s);
  3. serve — full-width smollm-360m (random weights from seed 0, bf16)
     behind ``DisaggServer`` on 16 requests; the kernels' launch counters
     are zeroed just before and read just after;
  4. whole model — the same weights in float32 through the kernels on the
     card and through the plain versions on the CPU: prefill of a 256-token
     prompt and 4 decode steps, logits compared.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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


def time_ms(fn, reps=20):
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(name, got, want, dtype):
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= tol + tol * want.float().abs()))
    log(f"  {name}: max_abs_err={err.max().item():.3e} tol={tol:g} "
        f"(atol=rtol) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


def bound_ms(flops, nbytes, dtype):
    t_f, t_b = flops / PEAK_FLOPS[dtype], nbytes / HBM_BW
    return max(t_f, t_b) * 1e3, ("operations" if t_f >= t_b else "bytes")


# ------------------------------------------------------------------ phase 2
def flash_case(name, dtype, T, S, D, *, q_offset=0, window=0, causal=True,
               B=1, H=16):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(T * 7 + S + D)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, window=window)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check(f"flash_attention[{name},{str(dtype)[6:]}]", got, want, dtype)
    qp = torch.arange(T, device="cuda")[:, None] + q_offset
    kp = torch.arange(S, device="cuda")[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device="cuda")
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    pairs = int(mask.sum())               # (query, key) pairs this data needs
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * B * T * H * D + 2 * B * S * H * D) * q.element_size()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
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


def decode_case(dtype, B=8, H=16, D=64, S=1024):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(S + D)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lengths = torch.tensor([1, S, 0, 17, 128, 129, S // 2, S - 24],
                           dtype=torch.int32, device="cuda")[:B]
    got = decode_attention(q, k, v, lengths)
    want = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = check(f"decode_attention[B={B},S={S},{str(dtype)[6:]}]", got, want,
                dtype)
    keys = int(lengths.sum())
    flops = 4.0 * H * D * keys
    nbytes = (2 * keys * H * D + 2 * B * H * D) * q.element_size() + 4 * B
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None])
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None])
    return _timed(f"decode_attention[B={B},S={S},{str(dtype)[6:]}]",
                  lambda: decode_attention(q, k, v, lengths),
                  lambda: decode_attention_plain(q, k, v, lengths), lib,
                  flops, nbytes, dtype, err)


def _timed(name, kernel, plain, lib, flops, nbytes, dtype, err):
    ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(lib)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    log(f"    {name}: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
        f"sdpa {lib_ms:.4f} ms | bound {b_ms:.5f} ms ({b_by}) | "
        f"{flops:.3e} flop {nbytes:.3e} B")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_kernels():
    log("[2] kernels against their plain versions on the card")
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = flash_case("prefill T=S=512 D=64", dtype, 512, 512, 64)
        if dtype is torch.bfloat16:
            main["flash_attention"] = r
        flash_case("suffix T=128 S=640 q_offset=512", dtype, 128, 640, 64,
                   q_offset=512)
        for D in (32, 96, 128):
            flash_case(f"D={D} T=S=256", dtype, 256, 256, D)
        flash_case("window=128 T=S=512", dtype, 512, 512, 64, window=128)
        flash_case("non-causal T=200 S=300", dtype, 200, 300, 64,
                   causal=False)
        r = decode_case(dtype)
        if dtype is torch.bfloat16:
            main["decode_attention"] = r
    return main


# ------------------------------------------------------------------ phase 3
def serve_once(model, reqs):
    """One ``DisaggServer.serve`` over ``reqs``; returns the results, the
    phase's wall seconds and the prefill / decode wall seconds and calls
    (each call ends in a device synchronise)."""
    from repro_torch.core import make_policy
    from repro_torch.serving import DisaggConfig, DisaggServer

    srv = DisaggServer(model, policy=make_policy("mfs"), cfg=DisaggConfig(
        n_prefill_units=2, decode_slots=8, decode_capacity=1024))
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


def phase_serve():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model

    log("[3] serve: full-width smollm-360m (bf16, seed 0) behind "
        "DisaggServer(mfs), 2 prefill units, 8 decode slots x 1024")
    cfg = ARCHS["smollm-360m"]
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                        generator=torch.Generator("cuda").manual_seed(0))
    reqs = make_requests(cfg, 16, 200.0, seed=0, mean_prompt=256, max_new=8)

    log("  run 1 (cold, counted):")
    flash_attention.launches = decode_attention.launches = 0
    res, calls, _ = serve_once(model, reqs)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    steps = max(len(r.tokens) for r in res) - 1
    log(f"  launches {launches} | prompt tokens "
        f"{sum(len(r.tokens) for r in reqs)} | reused "
        f"{sum(r.reused_tokens for r in res)} | slo "
        f"{sum(r.met_slo for r in res)}/{len(res)}")
    assert len(res) == len(reqs)
    assert all(0 <= r.first_token < cfg.vocab for r in res), "first token"
    assert all(0 <= t < cfg.vocab for r in res for t in r.tokens)
    assert any(r.reused_tokens >= 32 for r in res), "no prefix reuse"
    assert calls["prefill"] == len(reqs) and steps > 0
    assert launches["flash_attention"] >= len(reqs) * cfg.n_layers, launches
    assert launches["decode_attention"] >= cfg.n_layers * steps, launches

    log("  run 2 (warm):")
    _, _, warm = serve_once(model, reqs)
    log("  run 3 (warm, under torch.profiler):")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, traced = serve_once(model, reqs)
    # device-side events only (kernels, copies); the operator rows above
    # them would count the same device time twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
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
    return launches


# ------------------------------------------------------------------ phase 4
def phase_whole_model():
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model

    log("[4] whole model, float32: kernels on the card vs plain on the CPU")
    cfg = ARCHS["smollm-360m"]
    gpu = build_model(cfg, device="cuda", dtype=torch.float32,
                      generator=torch.Generator("cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(1, 260))
    n = 256
    diffs, scale = [], 0.0
    outs = {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        lg, caches = m.prefill({"tokens": toks[:, :n]})
        steps = [lg]
        caches = [[{"mix": {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4))
                            for k, t in layer["mix"].items()}}
                   for layer in seg] for seg in caches]
        for s in range(4):
            lg, caches = m.decode_step(caches, toks[:, n + s:n + s + 1], n + s)
            steps.append(lg)
        outs[name] = [x.float().cpu() for x in steps]
        log(f"  {name}: prefill + 4 decode steps {time.perf_counter() - t0:.3f} s")
    for a, b in zip(outs["cuda"], outs["cpu"]):
        diffs.append(float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    rel = max(diffs) / scale
    # float32 on both sides, TF32 off: only the order of summation differs
    # (cuBLAS vs the CPU GEMM, the kernels' online softmax vs the plain
    # one), ~1e-6 relative per op, compounding over 32 layers; 1e-3 of the
    # largest logit leaves two orders of margin and still catches a wrong
    # mask, position or cache write (those move logits by O(1) of scale)
    log(f"  max |logit diff| per step {['%.3e' % d for d in diffs]}, "
        f"max |logit| {scale:.3f}, relative {rel:.3e} (tol 1e-3)")
    if not rel <= 1e-3:
        raise SystemExit("whole-model logits disagree between card and CPU")
    return rel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[1] environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
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

    main_cases = phase_kernels()
    launches = phase_serve()
    phase_whole_model()

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:110"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:110")}
    kernels = [{"name": n, "route": "cuda", "source": sources[n][0],
                "replaces": sources[n][1], "launches": launches[n],
                **main_cases[n]} for n in ("flash_attention",
                                           "decode_attention")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
