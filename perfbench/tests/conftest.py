"""Puts the checkout's root and ``src`` on the path, as ``run.py`` does,
and holds the tiny configurations the CPU tests run."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips elsewhere")


TINY = {
    "name": "tiny-dense", "source": "test", "num_hidden_layers": 2,
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 16,
    "num_key_value_heads": 4, "head_dim": 8, "vocab_size": 512,
    "rope_theta": 10000.0, "norm_eps": 1e-06, "hidden_act": "silu",
    "mlp": "gated", "norm_type": "rmsnorm", "partial_rotary_factor": 1.0,
    "attention_bias": False, "tie_word_embeddings": False,
    "torch_dtype": "float32",
    "train": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
              "weight_decay": 0.1, "clip_norm": 1.0, "warmup": 1,
              "no_decay": ["ln_f"]},
}

SERVE_MIX = {
    "kind": "serve", "burst": 4, "gap_run": 2,
    "prompt": {"dist": "lognormal", "median": 48, "sigma": 0.5, "min": 24,
               "max": 96},
    "prefixes": {"share": 0.7, "zipf_s": 1.2, "min_suffix": 8,
                 "lengths": [32, 16]},
    "output": {"dist": "lognormal", "median": 3, "sigma": 0.3, "min": 2,
               "max": 4},
}
#: the generator's own test mix at deployment lengths: bursts of 8, gaps in
#: runs of 4, 8 Zipf-hot prefixes (no cell sends it)
BURST_MIX = {
    "kind": "serve", "burst": 8, "gap_run": 4,
    "prompt": {"dist": "lognormal", "median": 1536, "sigma": 0.5,
               "min": 256, "max": 3968},
    "prefixes": {"share": 0.7, "zipf_s": 1.2, "min_suffix": 64,
                 "lengths": [2048, 1536, 1280, 1024, 896, 768, 640, 512]},
    "output": {"dist": "lognormal", "median": 16, "sigma": 0.45, "min": 8,
               "max": 32},
}
SERVE_CELL = {"bursts_per_s": 2.0, "slo_bursts": 1, "policy": "mfs", "prefill_units": 2,
              "decode_slots": 4, "decode_capacity": 128, "page_size": 16,
              "pages": 256, "warmup_vocab": 64, "warmup_bursts": 1,
              "check_requests": 3, "limits": {"logit_gap": 1e-3}}
DECODE_MIX = {
    "kind": "decode", "pool": 6,
    "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8,
               "max": 48},
    "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 3,
               "max": 12},
}
DECODE_CELL = {"slots": 4, "capacity": 96, "warmup_steps": 1,
               "check_sequences": 2, "limits": {"logit_gap": 1e-3}}
TRAIN_MIX = {"kind": "train", "batch": 4, "seq": 16, "batches": 4}
TRAIN_CELL = {"checked_steps": 3, "trace_steps": 2,
              "limits": {"first_loss_gap": 1e-4, "first_grad_gap": 1e-3,
                         "change_gap": 1e-2}}
