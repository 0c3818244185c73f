"""Peak memory and step time of a few train steps on the card, for choosing
a training cell's batch or depth cut.

    python3 tools/train_probe.py --arch mamba2-1.3b --batch 8 --seq 1024
    python3 tools/train_probe.py --arch recurrentgemma-9b --depth 9 \
        --batch 1 --seq 2112

Builds the full-width config (cut to ``--depth`` layers if given), trains
``--steps`` steps through ``repro_torch.launch.train.train_loop`` (bf16
parameters, float32 AdamW moments, seed 0), then times one more step (host
clock to a sync). Prints the card's name and power limit, the losses, the
peak memory (``torch.cuda.max_memory_allocated``) and the step time, or
that the card ran out of memory (the answer this tool exists to give).
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--steps", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import synthetic_batch, train_loop

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    cfg = ARCHS[a.arch]
    if a.depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=a.depth)
    label = (f"{a.arch} depth {cfg.n_layers} ({cfg.params() / 1e9:.2f} B "
             f"parameters) B={a.batch} T={a.seq}")
    torch.cuda.reset_peak_memory_stats()
    try:
        state, losses, step_fn = train_loop(
            cfg, steps=a.steps, batch=a.batch, seq=a.seq, lr=1e-3, warmup=10,
            seed=0, log_every=0, device="cuda")
        batch = synthetic_batch(cfg, a.batch, a.seq, 0, a.steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    except torch.cuda.OutOfMemoryError as e:
        print(f"{label}: out of the card's memory ({str(e).splitlines()[0]})")
        return 0
    print(f"{label}: losses {['%.4f' % x for x in losses]}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, a warm step "
          f"{ms:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
