"""Probe the two attention kernels on one CUDA card (H100, sm_90a).

    python3 tools/attention_probe.py [--out FILE]

Measures what ``chip_smoke.py`` does not, at the serving shapes, in
bfloat16: each case's device time by CUDA-graph replay (as ``chip_smoke``
times it) and its kernels' device time one by one (``torch.profiler``: the
partial kernel and the split-KV combine apart), then the design choices
the kernels' sources cite:
  * decode's chunk count, the grid covering the SMs 1, 2 or 4 times
    (``decode_attention.split_plan(per_sm=)``, 4 being the default);
  * flash at head dim 256 with 64-key K/V tiles (a build of
    ``csrc/flash_attention.cu`` whose ``block_n`` returns 64, one block an
    SM) against the 32-key tiles the source takes (two blocks an SM).
Prints the card's name and power limit first. Needs the CUDA toolkit; exits
1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LOG = []


def log(*a):
    line = " ".join(str(x) for x in a)
    LOG.append(line)
    print(line, flush=True)


def per_kernel(fn, n=20):
    """Device microseconds a call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    def name(key):
        m = re.search(r"\w*kernel\w*(<[^>]*>)?", key)
        return m.group(0) if m else key[:40]
    return "; ".join(
        f"{name(e.key)} {e.self_device_time_total / e.count:.2f} us"
        for e in sorted(rows, key=lambda e: -e.self_device_time_total))


def flash_inputs(T, S, D, Hk, H=16, B=1, seed=0):
    from chip_smoke import kv_map_of
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, Hk, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v, kv_map_of(H, Hk)


FLASH = [("row 1: T=S=512 D=64", 512, 512, 64, 16, {}),
         ("GQA 16->5 T=S=512 D=64", 512, 512, 64, 5, {}),
         ("1b: T=S=2112 D=256 window 2048 MQA", 2112, 2112, 256, 1,
          dict(window=2048))] + [
    (f"suffix T={T} S={2048 + T} D=256 window 2048 MQA", T, 2048 + T, 256,
     1, dict(window=2048, q_offset=2048)) for T in (1, 17, 32)]
DECODE = [("row 2: B=8 S=1024 D=64", 8, 1024, 64, 16),
          ("GQA 16->5 B=8 S=1024 D=64", 8, 1024, 64, 5),
          ("2b: B=8 S=2048 D=256 MQA", 8, 2048, 256, 1)]


def flash_cases(names=None):
    from chip_smoke import graph_ms
    from repro_torch.kernels.flash_attention import flash_attention
    for name, T, S, D, Hk, kw in FLASH:
        if names and name not in names:
            continue
        q, k, v, m = flash_inputs(T, S, D, Hk)
        call = functools.partial(flash_attention, q, k, v, kv_map=m, **kw)
        log(f"  flash {name}: {graph_ms(call):.4f} ms | {per_kernel(call)}")


def decode_cases():
    from chip_smoke import graph_ms
    from repro_torch.kernels import decode_attention as mod
    plan = mod.split_plan
    for name, B, S, D, Hk in DECODE:
        q, k, v, m = flash_inputs(1, S, D, Hk, B=B)
        q = q[:, 0].contiguous()
        lengths = torch.tensor([1, S, 0, 17, 128, 129, S // 2, S - 24],
                               dtype=torch.int32, device="cuda")
        call = functools.partial(mod.decode_attention, q, k, v, lengths,
                                 kv_map=m)
        times = []
        try:
            for per_sm in (1, 2, 4):
                mod.split_plan = functools.partial(plan, per_sm=per_sm)
                times.append(f"per_sm {per_sm}: {graph_ms(call):.4f} ms")
        finally:
            mod.split_plan = plan
        log(f"  decode {name}: {' | '.join(times)} | {per_kernel(call)}")


def flash_64_key_tiles_at_256():
    """Build flash with 64-key tiles at every head dim and time the D=256
    cases with it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as mod
    src = (_build.CSRC / "flash_attention.cu").read_text()
    old = "constexpr int block_n() { return D > 128 ? 32 : 64; }"
    if old not in src:
        raise SystemExit("attention_probe: block_n changed; update the probe")
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(
        src.replace(old, "constexpr int block_n() { return 64; }"))
    for dep in _build.DEPS["flash_attention"]:
        shutil.copy(_build.CSRC / dep, out / dep)
    lib = out / "flash_attention_bn64.so"
    r = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib),
                        str(out / "flash_attention.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    entry = ""
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "registers" in line and "flash_mma_kernelILi256" in entry:
            log(f"  64-key tiles, flash_mma_kernel<256>: {line.strip()}")
    saved = _build._loaded.get("flash_attention")
    _build._loaded["flash_attention"] = ctypes.CDLL(str(lib))
    mod._tiling.cache_clear()
    try:
        log(f"  64-key tiles at D=256: tiling {mod._tiling(256)} "
            "(keys a tile, blocks an SM)")
        flash_cases([n for n, *_ in FLASH if "D=256" in n])
    finally:
        if saved is not None:
            _build._loaded["flash_attention"] = saved
        mod._tiling.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the report to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fmod
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip())
    libs = _build.build_all(["flash_attention", "decode_attention"])
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()[:150]}")
    log(f"[flash] tiling (keys a tile, blocks an SM): "
        f"D=64 {fmod._tiling(64)}, D=256 {fmod._tiling(256)}")
    flash_cases()
    log("[decode] chunks for the grid to cover the SMs per_sm times")
    decode_cases()
    log("[flash] the 32-key tiles at D=256 against 64-key ones")
    flash_64_key_tiles_at_256()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
