"""Probe the attention backward kernel on one CUDA card (H100, sm_90a).

    python3 tools/bwd_probe.py [--out FILE]

Measures what ``chip_smoke.py`` does not, in bfloat16 at the training
shapes of rows 5 (smollm-360m: B=8, T=S=1024, 16 query heads over 5, head
dim 64), 5s (starcoder2-3b: B=2, 32 over 2, head dim 128) and 5r
(recurrentgemma-9b: MQA, head dim 256, window 2048): each kernel's device
time per call (``torch.profiler``: delta, dK/dV, the splits' sum and dQ
apart) for four builds of ``csrc/flash_attention_bwd.cu``, run twice in
turns:
  * ``base``: the source as it is;
  * ``no_out``: built with ``-DBWD_PROBE_SKIP_OUT``, the output products
    (dV, dK, dQ) left out; the elementwise work between the products and
    the packing of p and ds stay (a timing only: wrong results);
  * ``no_score``: built with ``-DBWD_PROBE_SKIP_SCORES``, the score
    products (S and dP) left out (a timing only);
  * ``out_kmajor``: built with ``-DBWD_PROBE_OUT_KMAJOR``, the register-A
    output products (D = 64, 128) read their B tile (dO, Q or K)
    K-major, as the score products do, instead of transposed (MN-major):
    the same products over the same bytes in another order (a timing
    only).
Prints the card's name and power limit first, and each build's ptxas
report of registers, spills and injected waits (C7519, C7512). Needs the
CUDA toolkit; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LOG = []


def log(*a):
    line = " ".join(str(x) for x in a)
    LOG.append(line)
    print(line, flush=True)


def per_kernel(fn, n=20):
    """Device milliseconds a call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(delta|dkdv_wgmma|sum_splits|dq_wgmma)", e.key)
            name = m.group(1) if m else e.key[:30]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / n / 1e3
    return out


#: the builds: name -> nvcc defines
VARIANTS = {"base": (), "no_out": ("-DBWD_PROBE_SKIP_OUT",),
            "no_score": ("-DBWD_PROBE_SKIP_SCORES",),
            "out_kmajor": ("-DBWD_PROBE_OUT_KMAJOR",)}


def build(where):
    """Compile every build at once (one nvcc each); returns the libraries."""
    from repro_torch.kernels import _build
    where.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "flash_attention_bwd.cu"
    procs = {}
    for name, defines in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, *defines, "-o",
             str(where / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bwd_probe: {name} did not build:\n{out}")
        for line in out.splitlines():
            if re.search(r"registers|spill|C7519|C7512", line):
                log(f"  {name}: {line.strip()[:160]}")
    return {name: where / f"{name}.so" for name in VARIANTS}


def cases():
    """(label, arguments of flash_attention_bwd, keywords) of rows 5, 5s
    and 5r, inputs from a fixed seed."""
    from repro_torch.kernels.flash_attention import _forward
    rows = {"5 smollm D=64": (8, 1024, 64, 16, [min(h // 3, 4)
                                                for h in range(16)], 0),
            "5s starcoder2 D=128": (2, 1024, 128, 32,
                                    [min(h // 12, 1) for h in range(32)], 0),
            "5r MQA D=256 window": (1, 2112, 256, 16, [0] * 16, 2048)}
    out = []
    for label, (B, T, D, H, kv, window) in rows.items():
        Hk = max(kv) + 1
        g = torch.Generator(device="cuda").manual_seed(T + D)
        q = torch.randn(B, T, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, T, Hk, D, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        dout = torch.randn(B, T, H, D, generator=g, device="cuda").bfloat16()
        kw = dict(causal=True, window=window, q_offset=0, scale=None,
                  kv_map=torch.tensor(kv, dtype=torch.int32, device="cuda"))
        o, lse = _forward(q, k, v, with_lse=True, **kw)
        out.append((label, (q, k, v, o, lse, dout), dict(kw, kv_map_host=kv)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    libs = build(ROOT / "build" / "bwd_probe")
    inputs = cases()
    for turn in range(2):
        for name, lib in libs.items():
            _build._loaded["flash_attention_bwd"] = ctypes.CDLL(str(lib))
            for label, args, kw in inputs:
                t = per_kernel(lambda: fa.flash_attention_bwd(*args, **kw))
                log(f"turn {turn} {name:8s} {label:20s} total "
                    f"{sum(t.values()):.4f} ms | " +
                    " ".join(f"{k} {v:.4f}" for k, v in sorted(t.items())))
    if a.out:
        Path(a.out).write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
