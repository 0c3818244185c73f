"""The program's side: its model built from a configuration file and
loaded with the benchmark's weights, and its parameters read back in the
benchmark's layout. This is the only place that knows how ``repro_torch``
names and pads its parameters; ``repro_torch`` is imported inside the
functions."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .counts import dims


def arch(cfg: Dict[str, Any]):
    """The ``ArchConfig`` the port runs for a configuration file. Raises
    where the file asks for a block the port does not build."""
    from repro_torch.configs.base import ArchConfig
    run = (cfg["hidden_act"], cfg["mlp"], cfg["norm_type"],
           cfg["partial_rotary_factor"], cfg["attention_bias"],
           cfg["tie_word_embeddings"])
    if run != ("silu", "gated", "rmsnorm", 1.0, False, False):
        raise ValueError(f"{cfg['name']}: the port builds a SwiGLU MLP, "
                         f"RMSNorm, full RoPE, no bias, untied embeddings; "
                         f"the file asks for {run}")
    L, d, H, Hkv, hd, ff, V = dims(cfg)
    return ArchConfig(name=cfg["name"], family="dense", n_layers=L,
                      d_model=d, n_heads=H, n_kv=Hkv, d_ff=ff, vocab=V,
                      head_dim=hd, norm_eps=cfg["norm_eps"],
                      rope_theta=cfg["rope_theta"], source=cfg["source"])


def leaf_map(model: Any, cfg: Dict[str, Any]
             ) -> Dict[str, Tuple[torch.Tensor, Tuple[slice, ...]]]:
    """Each benchmark leaf's place in the program: (parameter, index). The
    port pads the query heads to a multiple of 16 (``wq`` columns and
    ``wo`` rows past the real heads) and the vocab to a multiple of 16;
    the real part is the first block of each."""
    L, d, H, Hkv, hd, ff, V = dims(cfg)
    p = dict(model.named_parameters())
    every = slice(None)
    out = {"embed": (p["embed"], (slice(0, V), every)),
           "unembed": (p["unembed.w"], (every, slice(0, V))),
           "ln_f": (p["ln_f.g"], (every,))}
    for layer in range(L):
        pre, b = f"seg0.{layer}.0.", f"layers.{layer}."
        out.update({
            b + "ln1": (p[pre + "ln1.g"], (every,)),
            b + "wq": (p[pre + "mix.wq.w"], (every, slice(0, H * hd))),
            b + "wk": (p[pre + "mix.wk.w"], (every, every)),
            b + "wv": (p[pre + "mix.wv.w"], (every, every)),
            b + "wo": (p[pre + "mix.wo.w"], (slice(0, H * hd), every)),
            b + "ln2": (p[pre + "ln2.g"], (every,)),
            b + "wg": (p[pre + "ffn.wg.w"], (every, every)),
            b + "wi": (p[pre + "ffn.wi.w"], (every, every)),
            b + "wd": (p[pre + "ffn.wo.w"], (every, every))})
    return out


@torch.no_grad()
def build(cfg: Dict[str, Any], leaves: Dict[str, torch.Tensor],
          device: Any):
    """The port's model of ``cfg`` on ``device`` holding ``leaves``: every
    parameter zeroed, then each leaf copied into its place (a padded
    head's q columns and output rows stay zero: an exact no-op head, as
    the port's own init makes it)."""
    from repro_torch.models import build_model
    from .weights import dtype_of
    model = build_model(arch(cfg), device=device, dtype=dtype_of(cfg))
    for prm in model.parameters():
        prm.zero_()
    places = leaf_map(model, cfg)
    if set(places) != set(leaves) or len(places) != len(
            [1 for _ in model.parameters()]):
        raise ValueError("the benchmark's leaves and the program's "
                         "parameters do not match one to one")
    for name, (prm, idx) in places.items():
        prm[idx].copy_(leaves[name])
    return model
