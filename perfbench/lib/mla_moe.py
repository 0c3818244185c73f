"""DeepSeek-V3 on the benchmark's side: the weights drawn from the seed,
the program's model built from a configuration file and loaded with them.
The only place that knows how ``repro_torch`` names and lays out an
MLA and expert model's parameters; ``repro_torch`` is imported inside the
functions, so a program without the model's settings fails at the build,
before any weight is drawn.

Leaves are named and laid out as the published checkpoint has them, each
matrix ``x @ w`` (``layers.<i>.`` then ``wq_a``, ``q_norm``, ``wq_b``,
``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``, the norms ``ln1``, ``ln2``; a
dense layer's ``wg``, ``wi``, ``wd``; an expert layer's ``router`` [d, E
published], ``router_bias`` [E published], the held experts' ``we_g``,
``we_i`` [n, d, F] and ``we_d`` [n, F, d], the shared expert's ``ws_g``,
``ws_i``, ``ws_d``). Every matrix is drawn in one ``normal_`` over one
flat bf16 buffer and scaled by 1/sqrt(its input width); the norm gains are
ones; the router bias is drawn in float32, N(0, ``router_bias_std``^2).

Loading (``build``) splits ``wkv_b``'s heads into the program's ``wk_b``
and ``wv_b`` and permutes the rope columns of ``wq_b`` (each head's last
``qk_rope_head_dim``) and of ``wkv_a`` (its last): the published rope
turns dims (2j, 2j + 1) together, the program's dims (j, j + D/2), and
``rope_perm`` maps the one onto the other.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .weights import dtype_of


def published_experts(cfg: Dict[str, Any]) -> int:
    return cfg["published"]["n_routed_experts"]


def arch(cfg: Dict[str, Any]):
    """The ``PortArch`` the program runs for the configuration file.
    Raises where the file asks for what the program does not build."""
    from repro_torch.models.arch import PortArch, PortSettings, Yarn
    rs = cfg["rope_scaling"]
    run = (cfg["hidden_act"], cfg["scoring_func"], cfg["topk_method"],
           cfg["norm_topk_prob"], cfg["moe_layer_freq"], rs["type"],
           cfg["attention_bias"], cfg["tie_word_embeddings"],
           cfg["num_nextn_predict_layers"])
    if run != ("silu", "sigmoid", "noaux_tc", True, 1, "yarn", False, False,
               0):
        raise ValueError(f"{cfg['name']}: the program builds DeepSeek-V3's "
                         f"blocks with no MTP layer; the file asks for {run}")
    port = PortSettings(
        router="sigmoid_group", n_group=cfg["n_group"],
        topk_group=cfg["topk_group"],
        routed_scale=cfg["routed_scaling_factor"],
        held=(cfg["held_first"], cfg["n_routed_experts"]),
        yarn=Yarn(factor=rs["factor"],
                  original=rs["original_max_position_embeddings"],
                  beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
                  mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"]))
    H = cfg["num_attention_heads"]
    return PortArch(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=H,
        n_kv=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], n_experts=published_experts(cfg),
        top_k=cfg["num_experts_per_tok"], n_shared=cfg["n_shared_experts"],
        d_expert=cfg["moe_intermediate_size"],
        first_dense=cfg["first_k_dense_replace"], use_mla=True,
        kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=cfg["q_lora_rank"],
        rope_head_dim=cfg["qk_rope_head_dim"],
        nope_head_dim=cfg["qk_nope_head_dim"],
        v_head_dim=cfg["v_head_dim"], norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), mtp=False,
        source=cfg["source"], port=port)


def leaf_specs(cfg: Dict[str, Any]
               ) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, std) of every leaf: std None for a norm gain, a
    negative std for the router bias (drawn apart, in float32)."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, qr = cfg["kv_lora_rank"], cfg["q_lora_rank"]
    ff, F_, n = (cfg["intermediate_size"], cfg["moe_intermediate_size"],
                 cfg["n_routed_experts"])
    E = published_experts(cfg)
    out = [("embed", (V, d), 1 / math.sqrt(d))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), None),
                (p + "wq_a", (d, qr), 1 / math.sqrt(d)),
                (p + "q_norm", (qr,), None),
                (p + "wq_b", (qr, H * (dn + dr)), 1 / math.sqrt(qr)),
                (p + "wkv_a", (d, r + dr), 1 / math.sqrt(d)),
                (p + "kv_norm", (r,), None),
                (p + "wkv_b", (r, H * (dn + dv)), 1 / math.sqrt(r)),
                (p + "wo", (H * dv, d), 1 / math.sqrt(H * dv)),
                (p + "ln2", (d,), None)]
        if i < cfg["first_k_dense_replace"]:
            out += [(p + "wg", (d, ff), 1 / math.sqrt(d)),
                    (p + "wi", (d, ff), 1 / math.sqrt(d)),
                    (p + "wd", (ff, d), 1 / math.sqrt(ff))]
        else:
            out += [(p + "router", (d, E), 1 / math.sqrt(d)),
                    (p + "router_bias", (E,), -cfg["router_bias_std"]),
                    (p + "we_g", (n, d, F_), 1 / math.sqrt(d)),
                    (p + "we_i", (n, d, F_), 1 / math.sqrt(d)),
                    (p + "we_d", (n, F_, d), 1 / math.sqrt(F_)),
                    (p + "ws_g", (d, F_), 1 / math.sqrt(d)),
                    (p + "ws_i", (d, F_), 1 / math.sqrt(d)),
                    (p + "ws_d", (F_, d), 1 / math.sqrt(F_))]
    out += [("ln_f", (d,), None), ("unembed", (d, V), 1 / math.sqrt(d))]
    return out


def n_params(cfg: Dict[str, Any]) -> int:
    return sum(math.prod(s) for _, s, _ in leaf_specs(cfg))


@torch.no_grad()
def make(cfg: Dict[str, Any], seed: int, device: Any
         ) -> Dict[str, torch.Tensor]:
    """Every leaf of the configuration, drawn from ``seed`` on ``device``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(s) for _, s, std in specs
                if std is not None and std > 0)
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=dtype_of(cfg), device=device)
    buf.normal_(generator=g)
    out, off = {}, 0
    for name, shape, std in specs:
        if std is None:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif std < 0:
            out[name] = torch.empty(shape, dtype=torch.float32,
                                    device=device).normal_(generator=g) * -std
        else:
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape).mul_(std)
            off += n
    return out


def rope_perm(dim: int) -> torch.Tensor:
    """The published rope column at each of the program's: the program's
    dim j < D/2 is the published 2j, its dim D/2 + j the published 2j + 1."""
    return torch.cat([torch.arange(0, dim, 2), torch.arange(1, dim, 2)])


def _blocks(model, cfg: Dict[str, Any]):
    """(layer index, the program's layer) in order."""
    k = cfg["first_k_dense_replace"]
    for c, block in enumerate(model.seg0):
        yield c, block[0]
    for c, block in enumerate(model.seg1):
        yield k + c, block[0]


@torch.no_grad()
def build(cfg: Dict[str, Any], leaves: Dict[str, torch.Tensor], device: Any):
    """The program's model of ``cfg`` on ``device`` holding ``leaves``;
    raises unless each leaf fills its parameters and every parameter is
    filled."""
    from repro_torch.models import build_model
    model = build_model(arch(cfg), device=device, dtype=dtype_of(cfg))
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    perm = rope_perm(dr).to(device)
    filled = set()

    def put(prm, value):
        prm.copy_(value)
        filled.add(id(prm))

    put(model.embed, leaves["embed"])
    put(model.unembed.w, leaves["unembed"])
    put(model.ln_f.g, leaves["ln_f"])
    for i, L in _blocks(model, cfg):
        w = {n[len(f"layers.{i}."):]: t for n, t in leaves.items()
             if n.startswith(f"layers.{i}.")}
        m = L.mix
        put(L.ln1.g, w["ln1"])
        put(L.ln2.g, w["ln2"])
        put(m.wq_a.w, w["wq_a"])
        put(m.q_norm.g, w["q_norm"])
        q = w["wq_b"].view(-1, H, dn + dr)
        put(m.wq_b.w, torch.cat([q[..., :dn], q[..., dn:][..., perm]],
                                -1).view(-1, H * (dn + dr)))
        put(m.wkv_a.w, torch.cat([w["wkv_a"][:, :r],
                                  w["wkv_a"][:, r:][:, perm]], -1))
        put(m.kv_norm.g, w["kv_norm"])
        kvb = w["wkv_b"].view(r, H, dn + dv)
        put(m.wk_b.w, kvb[..., :dn].reshape(r, H * dn))
        put(m.wv_b.w, kvb[..., dn:].reshape(r, H * dv))
        put(m.wo.w, w["wo"])
        if L.ffn is not None:
            put(L.ffn.wg.w, w["wg"])
            put(L.ffn.wi.w, w["wi"])
            put(L.ffn.wo.w, w["wd"])
            continue
        e = L.ffn_moe
        put(e.router, w["router"])
        put(e.router_bias, w["router_bias"])
        put(e.w_gate, w["we_g"])
        put(e.w_in, w["we_i"])
        put(e.w_out, w["we_d"])
        put(e.shared.wg.w, w["ws_g"])
        put(e.shared.wi.w, w["ws_i"])
        put(e.shared.wo.w, w["ws_d"])
    missing = [n for n, p in model.named_parameters() if id(p) not in filled]
    if missing or len(filled) != len(list(model.parameters())):
        raise ValueError(f"parameters the benchmark's leaves do not fill: "
                         f"{missing[:5]}")
    return model
