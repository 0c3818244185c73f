"""End-to-end training with the PyTorch port: a SmolLM variant for a few
hundred steps with checkpoint/restart fault tolerance, on the card unless
``--device cpu``.

The port's counterpart of ``examples/train_smollm.py``, the same run: the
smollm-360m family at width 256 (~15M params; ``--width 960`` for the real
360M width), AdamW with clipping and warmup, the deterministic data
stream, a checkpoint every 50 steps (in the JAX package's format), and a
simulated failure half way, after which a relaunch resumes from the newest
checkpoint and continues as the straight run would.

    PYTHONPATH=src python examples/train_smollm_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_smollm_torch.py --device cpu \\
        --steps 40
"""
import argparse
import dataclasses
import tempfile

import repro_torch.launch.train as T
from repro_torch.configs import ARCHS


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_train_smollm_")

    base = ARCHS["smollm-360m"]
    cfg = dataclasses.replace(
        base, name="smollm-ex", d_model=args.width,
        n_heads=max(1, args.width // 64), n_kv=max(1, args.width // 192),
        d_ff=args.width * 8 // 3, vocab=8192, n_layers=12)
    print(f"training {cfg.name}: {cfg.params()/1e6:.1f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq} on "
          f"{args.device}, checkpoints in {ckpt}")

    # the launcher looks archs up by name: register the custom width
    T.SMOKES = dict(T.SMOKES)
    T.SMOKES["smollm-ex"] = cfg

    half = args.steps // 2
    kw = dict(batch=args.batch, seq=args.seq, ckpt_dir=ckpt, ckpt_every=50,
              log_every=20, device=args.device)
    _, losses = T.run("smollm-ex", steps=half, **kw)
    print(f"\n-- simulated failure at step {half}; relaunching --\n")
    _, more = T.run("smollm-ex", steps=args.steps, resume=True, **kw)
    losses += more
    print(f"\nloss: start {losses[0]:.3f} -> end {losses[-1]:.3f} "
          f"({len(losses)} logged steps, resumed across a failure)")
    assert losses[-1] < losses[0], "training did not make progress"


if __name__ == "__main__":
    main()
