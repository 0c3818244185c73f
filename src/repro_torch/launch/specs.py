"""Per-(architecture x input-shape) cells of the dry run
(``repro.launch.specs``'s counterpart).

For every cell this module builds one rank's share of the step the JAX
package deploys for that shape kind, on the ``meta`` device (no weights,
no data, no kernel launched: ``kernels.meta``):
  * train_*   -> ``make_train_step`` (loss, backward, AdamW, remat)
  * prefill_* -> ``Model.prefill`` (logits + KV cache)
  * decode_* / long_* -> ``Model.decode_step`` (one token against a full
    cache from ``Model.init_cache``)
over the rank's inputs, meta tensors where JAX has ``ShapeDtypeStruct``
stand-ins, on a ``launch.mesh.DryMesh`` (the rank's coordinates on the
production mesh; its collectives record their calls). JAX's in/out
shardings have no counterpart: the rank's tensors are its shards
(``launch.shardings``), and the meta tensors the step takes are those.

Cell-level policy, as the JAX package's:
  * decode KV caches are sequence-sharded over "model" (``kv_seq_shard``)
    and store the real (unpadded) KV heads;
  * qwen1.5-32b decode_32k stores int8 KV, the only cell whose bf16 cache
    exceeds pod HBM;
  * DeepSeek-V3 runs 2D expert parallelism over ("data", "model");
  * training runs ZeRO-3 over the batch axes with remat; DeepSeek-V3
    training keeps its optimizer moments in bf16;
  * ``long_500k`` runs only for the bounded-state archs (mamba2,
    recurrentgemma); the 8 full-attention archs are documented skips.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES
from ..configs.base import ArchConfig, ShapeCell
from ..models.lm import build_model
from ..models.sharding import ShardCtx
from ..training.optim import AdamWConfig, adamw_init
from ..training.trainer import TrainState, make_train_step
from .shardings import shard_batch

__all__ = ["Cell", "plan_cells", "build_cell", "input_specs", "make_ctx",
           "SKIP_REASONS", "KV_DTYPE_OVERRIDES"]

# archs with an O(1)-state long-context path; everyone else skips long_500k
_SUBQUADRATIC = {"mamba2-1.3b", "recurrentgemma-9b"}

SKIP_REASONS: Dict[Tuple[str, str], str] = {
    (a, "long_500k"): ("pure full attention: a 524288-token dense KV cache "
                       "has no sub-quadratic path (documented skip)")
    for a in ARCHS if a not in _SUBQUADRATIC
}

#: cells whose bf16 KV cache exceeds pod HBM -> int8 storage
KV_DTYPE_OVERRIDES: Dict[Tuple[str, str], Any] = {
    ("qwen1.5-32b", "decode_32k"): torch.int8,
}

#: MoE archs whose expert bank needs pod-wide (2D) expert parallelism
_EP_2D = {"deepseek-v3-671b"}

#: what the meta device cannot read on the host, as each cell's notes say
_MOE_NOTE = ("meta: the grouped experts' buffer takes the balanced group "
             "ceil(rows / E) and every received EP slot counts as filled "
             "(blocks._host_count)")
_DECODE_NOTE = ("decode attention's operations counted over every cache "
                "slot")


@dataclass
class Cell:
    arch: str
    shape: ShapeCell
    kind: str                                  # train | prefill | decode
    fn: Callable = None
    args: Tuple = ()                           # the rank's meta inputs
    model_flops: float = 0.0                   # 6ND / 2ND per step
    skip: Optional[str] = None
    kv_dtype: Any = torch.bfloat16
    notes: str = ""
    #: the rank's inputs by kind (params, moments, caches, batch), for
    #: ``launch.dryrun``'s residency
    inputs: Dict[str, Any] = field(default_factory=dict)


def plan_cells(archs: Optional[List[str]] = None,
               shapes: Optional[List[str]] = None) -> List[Cell]:
    out = []
    for a in (archs or list(ARCHS)):
        for s in SHAPES:
            if shapes and s.name not in shapes:
                continue
            out.append(Cell(arch=a, shape=s, kind=s.kind,
                            skip=SKIP_REASONS.get((a, s.name)),
                            kv_dtype=KV_DTYPE_OVERRIDES.get(
                                (a, s.name), torch.bfloat16)))
    return out


# =====================================================================
# context / policy selection
# =====================================================================
def make_ctx(cfg: ArchConfig, mesh, shape: ShapeCell) -> ShardCtx:
    multi_pod = "pod" in mesh.names
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    ep_axes = (("data", "model") if cfg.name in _EP_2D else ("model",))
    return ShardCtx(
        mesh=mesh,
        batch_axes=batch_axes,
        zero3=(shape.kind == "train"),
        zero3_axes=batch_axes,
        ep_axes=ep_axes,
        kv_seq_shard=(shape.kind == "decode"),
    )


def _src_len(cfg: ArchConfig, seq_len: int) -> int:
    """Encoder frame count for the stubbed audio frontend."""
    return max(16, min(4096, seq_len // 4))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# =====================================================================
# input specs (meta stand-ins, the global batch)
# =====================================================================
def input_specs(arch: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for one cell: meta tensors of the global
    batch's shapes and dtypes."""
    cfg = ARCHS[arch]
    shape = next(s for s in SHAPES if s.name == shape_name)
    B = shape.global_batch
    if shape.kind == "decode":
        return {"tok": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    return _model_batch(cfg, shape)


# =====================================================================
# cell building
# =====================================================================
def build_cell(cell: Cell, mesh, cfg: Optional[ArchConfig] = None,
               remat: Optional[bool] = None, **changes) -> Cell:
    """Populate ``cell`` with the step ``fn`` and the rank's meta inputs
    ``args`` on ``mesh`` (a ``DryMesh``, or any mesh of the port). Off the
    JAX package's policy, to size other runs: ``cfg`` in place of the
    arch's config (a depth cut), ``remat`` in place of train's, and
    ``changes`` to ``make_ctx``'s ``ShardCtx`` (``zero3=False``)."""
    cfg = cfg or ARCHS[cell.arch]
    shape = cell.shape
    ctx = dataclasses.replace(make_ctx(cfg, mesh, shape), **changes)
    model = build_model(cfg, device="meta", ctx=ctx,
                        remat=(shape.kind == "train") if remat is None
                        else remat)
    params = dict(model.named_parameters())
    cell.inputs = {"params": params}
    notes = [_MOE_NOTE] if cfg.n_experts else []
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype=(torch.bfloat16 if cfg.name == "deepseek-v3-671b"
                         else torch.float32))
        model.requires_grad_(True)
        step = make_train_step(model, opt_cfg)
        state = TrainState(params, adamw_init(params, opt_cfg), 0)
        batch = shard_batch(_model_batch(cfg, shape), ctx)
        cell.fn = step
        cell.args = (state, batch)
        cell.inputs.update(m=state.opt.m, v=state.opt.v, batch=batch)
        cell.model_flops = 6.0 * cfg.params_active() * shape.global_batch \
            * shape.seq_len
    elif shape.kind == "prefill":
        batch = shard_batch(_model_batch(cfg, shape), ctx)
        cell.fn = model.prefill
        cell.args = (batch,)
        cell.inputs["batch"] = batch
        cell.model_flops = 2.0 * cfg.params_active() * shape.global_batch \
            * shape.seq_len
    else:                                               # decode / long
        B, S = shape.global_batch, shape.seq_len
        split = ctx.split(0, ctx.batch_axes, B)
        rows = B if split is None else B // split.parts
        src = _src_len(cfg, S) if cfg.enc_layers else 0
        caches = model.init_cache(rows, S, cell.kv_dtype, src_len=src)
        tok = _meta((rows, 1), torch.int32)
        pos = _meta((), torch.int32)
        cell.fn = model.decode_step
        cell.args = (caches, tok, pos)
        cell.inputs.update(caches=caches, batch={"tok": tok, "pos": pos})
        cell.model_flops = 2.0 * cfg.params_active() * B
        notes.append(_DECODE_NOTE)
    cell.notes = "; ".join(notes)
    return cell


def _model_batch(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """The global batch as meta tensors, in the model's own key naming."""
    B, T = shape.global_batch, shape.seq_len
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        batch["inputs_embeds"] = _meta((B, T, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, T), torch.int32)
    if cfg.enc_layers:
        batch["src_embeds"] = _meta((B, _src_len(cfg, T), cfg.d_model),
                                    torch.bfloat16)
    if shape.kind == "train":
        batch["labels"] = _meta((B, T), torch.int32)
        if cfg.mtp:
            batch["labels2"] = _meta((B, T), torch.int32)
    return batch
