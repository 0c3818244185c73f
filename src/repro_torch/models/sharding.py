"""The sharding context (the JAX package's ``ShardCtx``) over
``torch.distributed``, and the collectives the sharded blocks run.

Mesh axes are ``("data", "model")`` (``launch.mesh.make_mesh_for``), or
``("pod", "data", "model")`` on the multi-pod production mesh
(``launch.mesh.make_production_mesh``):

  * batch rows            -> ``batch_axes``: "data", or ("pod", "data")
                             (data parallelism, DP)
  * a parameter's other
    dim                   -> ``zero3_axes`` with ``zero3`` (ZeRO-3: the
                             dim that TP does not split, split over the
                             data axes too; see ``gather_param``)
  * attention heads, d_ff,
    the vocab             -> "model"  (tensor parallelism, TP)
  * the expert bank       -> ``ep_axes``: ("model",) or ("data", "model")
                             (expert parallelism, EP)
  * decode cache slots    -> "model" with ``kv_seq_shard`` (the JAX
                             package's flash-decoding layout: a rank holds
                             a block of every sequence's slots)

Query heads and the vocab pad to a multiple of ``HEAD_PAD`` (16) whatever
the mesh (``ShardCtx.head_multiple``; wider than 16 the multiple grows), so
the parameter layout does not depend on the mesh and a checkpoint of
logical arrays loads onto any mesh; padded heads are exact no-ops.

``ShardCtx()`` (no mesh) is the single-device model: every collective below
returns its input untouched, as does any collective over axes of size 1, so
a ``(1, 1)`` mesh runs the same operations as no mesh.

Each rank holds its shard of a parameter (``Split``: the dim, the axes it
is split over and the rank's block) and the blocks sum partial products
with the Megatron-style pair: ``copy_to`` (identity forward, the gradient
summed over the axes in the backward) where a replicated activation enters
the rank's shard of a layer, ``reduce_from`` (the sum forward, identity
backward) where partial outputs leave it. ``gather_from``/``scatter_to``
split and rebuild a dim, ``exchange`` is the EP ``all_to_all``.

Under ``zero3`` a parameter carries a second ``Split``, ``z3``, of the dim
TP leaves whole (``launch.shardings.param_placement``; ``splits_of`` gives
both), and every read of it in a forward goes through ``gather_param``: the
blocks gathered over the zero3 axes, the gradient summed over them in
float32 and the rank's block kept (a reduce-scatter).

Every collective over more than one rank adds its kind (the JAX package's
HLO names: ``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``), one call and its result's bytes to the mesh's ``log``
(``CollectiveLog``), as the JAX dry run counts them in the partitioned HLO.
On a dry mesh (``launch.mesh.DryMesh``, ``backend`` "dry") a collective
records the call and returns an uninitialised result of its shape: the dry
run (``launch.dryrun``) runs a rank's step on the meta device that way.

A gloo group cannot take a CUDA tensor for every collective, so with the
gloo backend a CUDA tensor is copied through host memory; that is decided
from the backend and the tensor's device, before the call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["HEAD_PAD", "pad_to_multiple", "Split", "ShardCtx", "EPStats",
           "CollectiveLog", "splits_of", "shard_tensor", "all_reduce",
           "all_gather", "reduce_scatter", "gather_to_first", "all_to_all",
           "copy_to", "reduce_from", "gather_from", "scatter_to",
           "gather_partial", "gather_param", "exchange", "slot_block"]

HEAD_PAD = 16

Axes = Tuple[str, ...]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Split(NamedTuple):
    """A parameter's shard: ``dim`` split into ``parts`` blocks over the
    mesh ``axes`` (row-major), of which the rank holds block ``index``."""
    dim: int
    axes: Axes
    index: int
    parts: int


Splits = Union[None, Split, Tuple[Split, ...]]


def splits_of(p: Union[torch.Tensor, Splits]) -> Tuple[Split, ...]:
    """The ``Split``s of a parameter (its TP or EP ``shard``, then its
    ZeRO-3 ``z3``), or of a ``Split``, a tuple of them or None: each
    splits another dim."""
    if isinstance(p, torch.Tensor):
        p = (getattr(p, "shard", None), getattr(p, "z3", None))
    if p is None or isinstance(p, Split):
        p = (p,)
    return tuple(s for s in p if s is not None)


def shard_tensor(t: torch.Tensor, split: Splits) -> torch.Tensor:
    """The rank's block of the logical ``t`` under ``split`` (a ``Split``,
    a tuple of them, or None: ``t`` itself)."""
    for s in splits_of(split):
        n = t.shape[s.dim] // s.parts
        t = t.narrow(s.dim, s.index * n, n)
    return t


@dataclass
class EPStats:
    """What the expert-parallel MoE layers did since the counters were last
    zeroed: the (token, expert) pairs dropped past the capacity (a 0-dim
    device tensor, summed without a host read), the ``all_to_all`` calls
    and the bytes a rank sent to the others through them, and the branch
    each call took; and the bytes a rank sent in the sequence-sharded
    decode's exchanges (its queries gathered, its partials sent),
    ``seq_bytes``."""
    dropped: Any = 0
    pairs: int = 0
    a2a_calls: int = 0
    a2a_bytes: int = 0
    branches: dict = field(default_factory=dict)
    seq_bytes: int = 0

    def zero(self) -> None:
        self.dropped, self.pairs, self.a2a_calls, self.a2a_bytes = 0, 0, 0, 0
        self.branches = {}
        self.seq_bytes = 0


class CollectiveLog:
    """The collectives a rank ran since ``zero()``, by kind under the JAX
    package's names: ``{kind: {"count", "bytes"}}`` of the results, and
    ``total_bytes`` (``as_dict``, the JAX dry run's ``collective_bytes``)."""

    KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

    def __init__(self):
        self.zero()

    def zero(self) -> None:
        self.kinds = {k: {"count": 0, "bytes": 0} for k in self.KINDS}

    def add(self, kind: str, shape, dtype: torch.dtype) -> None:
        n = 1
        for d in shape:
            n *= int(d)
        rec = self.kinds[kind]
        rec["count"] += 1
        rec["bytes"] += n * dtype.itemsize

    def as_dict(self) -> dict:
        out = {k: dict(v) for k, v in self.kinds.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.kinds.values())
        return out


@dataclass
class ShardCtx:
    """Carries the mesh and the axis names through model construction.

    ``mesh=None`` is the single-device model. ``mesh`` is a
    ``launch.mesh.Mesh`` (its ``shape`` by axis name, the rank's
    coordinates and a process group per axis tuple). ``ep_axes`` selects
    the expert-parallel axes: ("model",) is classic EP within TP,
    ("data", "model") spreads the experts over every rank.

    ``kv_seq_shard``: decode caches are sequence-sharded over the model
    axis (the JAX package's decode layout, ``launch.specs.make_ctx``): a
    rank holds every real KV head (or MLA latent) over its block of slots
    (``slot_block``), runs the decode kernel over them and merges its query
    heads' partials with the other ranks' (``blocks.attn_apply``,
    ``blocks.mla_apply``). Prefill and training are as without it; at a
    model axis of one rank it changes nothing.

    ``zero3``: training's ZeRO-3 (the JAX package's training layout,
    ``launch.specs.make_ctx``): each parameter's dim that TP leaves whole
    is also split over ``zero3_axes`` where they divide it (the ``z3``
    split, ``launch.shardings.param_placement``), gathered at each read
    (``gather_param``), its gradient reduce-scattered; the optimizer
    moments are the parameter's shards.
    """

    mesh: Optional[Any] = None
    batch_axes: Axes = ("data",)
    model_axis: str = "model"
    ep_axes: Axes = ("model",)
    #: heads are padded to a multiple of this whatever the live mesh, so the
    #: parameter layout is mesh-independent
    head_pad: int = HEAD_PAD
    zero3: bool = False
    zero3_axes: Axes = ("data",)
    kv_seq_shard: bool = False
    stats: EPStats = field(default_factory=EPStats)

    @property
    def seq_sharded(self) -> bool:
        """Decode caches are split by slots over more than one rank."""
        return self.kv_seq_shard and self.model_size > 1

    # ------------------------------------------------------------ sizes
    def size(self, axes: Union[str, Sequence[str]]) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= self.mesh.shape[a]
        return n

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """The rank's row-major index over ``axes``."""
        if self.mesh is None:
            return 0
        idx = 0
        for a in (axes,) if isinstance(axes, str) else axes:
            idx = idx * self.mesh.shape[a] + self.mesh.coord(a)
        return idx

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis)

    @property
    def ep_size(self) -> int:
        return self.size(self.ep_axes)

    @property
    def data_size(self) -> int:
        return self.size(self.batch_axes)

    @property
    def head_multiple(self) -> int:
        m = self.model_size
        return (self.head_pad * ((m + self.head_pad - 1) // self.head_pad)
                if m > self.head_pad else self.head_pad)

    def split(self, dim: int, axes: Union[str, Sequence[str]], n: int
              ) -> Optional[Split]:
        """The rank's ``Split`` of a dim of ``n`` over ``axes``; None (kept
        whole) when the axes have one rank or do not divide ``n``, as the
        JAX package's ``_guarded`` keeps it replicated."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        parts = self.size(axes)
        if parts == 1 or n % parts:
            return None
        return Split(dim, axes, self.index(axes), parts)


def slot_block(ctx: Optional[ShardCtx], S: int) -> Tuple[int, int]:
    """The rank's block ``[lo, lo + n)`` of a sequence-sharded decode
    cache's ``S`` slots over the model axis, as ``(lo, n)``: ``(0, S)``
    unless ``ctx.kv_seq_shard`` with more than one rank there. Raises
    unless the ranks divide ``S`` (the JAX layout's sharding needs that
    too)."""
    if ctx is None or not ctx.seq_sharded:
        return 0, S
    m = ctx.model_size
    if S % m:
        raise ValueError(f"a sequence-sharded cache of {S} slots over {m} "
                         "ranks: the ranks must divide the slots")
    n = S // m
    return ctx.index(ctx.model_axis) * n, n


# ------------------------------------------------------------- collectives
def _active(ctx: Optional[ShardCtx], axes) -> bool:
    return ctx is not None and ctx.size(axes) > 1


def _axes(axes) -> Axes:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _staged(ctx: ShardCtx, t: torch.Tensor) -> bool:
    """gloo takes host tensors: a CUDA tensor goes through host memory."""
    return ctx.mesh.backend == "gloo" and t.is_cuda


def _record(ctx: ShardCtx, kind: str, shape, dtype) -> bool:
    """Add the call to the mesh's ``log``; True on a dry mesh, where the
    caller returns an uninitialised result of ``shape`` instead."""
    log = getattr(ctx.mesh, "log", None)
    if log is not None:
        log.add(kind, shape, dtype)
    return ctx.mesh.backend == "dry"


def all_reduce(t: torch.Tensor, ctx: Optional[ShardCtx], axes,
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``t`` over the ranks of ``axes``, as a
    new tensor."""
    if not _active(ctx, axes):
        return t
    if _record(ctx, "all-reduce", t.shape, t.dtype):
        return torch.empty_like(t)
    staged = _staged(ctx, t)
    buf = t.detach().to("cpu" if staged else t.device, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM,
                    group=ctx.mesh.group(_axes(axes)))
    return buf.to(t.device) if staged else buf


def all_gather(t: torch.Tensor, ctx: Optional[ShardCtx], axes,
               dim: int) -> torch.Tensor:
    """The ranks' ``t`` over ``axes`` concatenated along ``dim`` in
    row-major rank order."""
    if not _active(ctx, axes):
        return t
    shape = list(t.shape)
    shape[dim] *= ctx.size(axes)
    if _record(ctx, "all-gather", shape, t.dtype):
        return t.new_empty(shape)
    staged = _staged(ctx, t)
    src = t.detach().to("cpu" if staged else t.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(ctx.size(axes))]
    dist.all_gather(parts, src, group=ctx.mesh.group(_axes(axes)))
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, ctx: Optional[ShardCtx], axes,
                   dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of the sum of ``t`` over the ranks of
    ``axes`` (blocks in row-major rank order), as a new tensor: an
    ``all_reduce`` and the block kept (gloo has no reduce-scatter)."""
    if not _active(ctx, axes):
        return t
    n = t.shape[dim] // ctx.size(axes)
    shape = list(t.shape)
    shape[dim] = n
    if _record(ctx, "reduce-scatter", shape, t.dtype):
        return t.new_empty(shape)
    staged = _staged(ctx, t)
    buf = t.detach().to("cpu" if staged else t.device, copy=True)
    dist.all_reduce(buf, group=ctx.mesh.group(_axes(axes)))
    out = buf.narrow(dim, ctx.index(axes) * n, n).contiguous()
    return out.to(t.device) if staged else out


def gather_to_first(t: torch.Tensor, ctx: ShardCtx, axes, dim: int
                    ) -> Optional[torch.Tensor]:
    """The ranks' ``t`` over ``axes`` concatenated along ``dim`` on the
    group's first rank (row-major), None on the others. Logged as an
    ``all-gather`` of what the first rank receives."""
    if not _active(ctx, axes):
        return t
    shape = list(t.shape)
    shape[dim] *= ctx.size(axes)
    if _record(ctx, "all-gather", shape, t.dtype):
        return None if ctx.index(axes) else t.new_empty(shape)
    staged = _staged(ctx, t)
    src = t.detach().to("cpu" if staged else t.device).contiguous()
    group = ctx.mesh.group(_axes(axes))
    first = dist.get_global_rank(group, 0)
    parts = ([torch.empty_like(src) for _ in range(ctx.size(axes))]
             if ctx.mesh.rank == first else None)
    dist.gather(src, parts, dst=first, group=group)
    return None if parts is None else torch.cat(parts, dim).to(t.device)


def all_to_all(t: torch.Tensor, ctx: Optional[ShardCtx], axes
               ) -> torch.Tensor:
    """``t`` [n, ...] with n the ranks of ``axes``: block i goes to rank i,
    and block i of the result came from rank i."""
    if not _active(ctx, axes):
        return t
    if _record(ctx, "all-to-all", t.shape, t.dtype):
        return torch.empty_like(t)
    staged = _staged(ctx, t)
    src = t.detach().to("cpu" if staged else t.device).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=ctx.mesh.group(_axes(axes)))
    return out.to(t.device) if staged else out


def _block(t: torch.Tensor, ctx: ShardCtx, axes, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ctx.size(axes)
    return t.narrow(dim, ctx.index(axes) * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.args = (ctx, axes)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(g, *fctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        return all_reduce(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.args = (ctx, axes, dim)
        return all_gather(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return _block(g, *fctx.args).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.args = (ctx, axes, dim)
        return _block(x, ctx, axes, dim).contiguous()

    @staticmethod
    def backward(fctx, g):
        return all_gather(g, *fctx.args), None, None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim, acc):
        fctx.args, fctx.acc = (ctx, axes, dim), acc
        return all_gather(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        acc = g.dtype if fctx.acc is None else fctx.acc
        return (reduce_scatter(g.to(acc), *fctx.args).to(g.dtype), None,
                None, None, None)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.args = (ctx, axes)
        return all_to_all(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return all_to_all(g, *fctx.args), None, None


def copy_to(x, ctx: Optional[ShardCtx], axes):
    """A replicated activation entering the rank's shard of a layer:
    identity, and the rank's partial gradient summed over ``axes``."""
    return _CopyTo.apply(x, ctx, axes) if _active(ctx, axes) else x


def reduce_from(x, ctx: Optional[ShardCtx], axes):
    """Partial outputs summed over ``axes``; the gradient passes as it
    is (every rank's is the whole gradient of the replicated sum)."""
    return _ReduceFrom.apply(x, ctx, axes) if _active(ctx, axes) else x


def gather_from(x, ctx: Optional[ShardCtx], axes, dim: int):
    """The ranks' blocks of a replicated activation joined along ``dim``;
    the gradient's own block goes back."""
    return _GatherFrom.apply(x, ctx, axes, dim) if _active(ctx, axes) else x


def scatter_to(x, ctx: Optional[ShardCtx], axes, dim: int):
    """The rank's block of a replicated activation along ``dim``; the
    blocks' gradients gathered back."""
    return _ScatterTo.apply(x, ctx, axes, dim) if _active(ctx, axes) else x


def gather_partial(x, ctx: Optional[ShardCtx], axes, dim: int,
                   acc: Optional[torch.dtype] = None):
    """The ranks' ``x`` joined along ``dim`` into an input of which every
    rank computes a partial result: the gradient is summed over ``axes``
    (in ``acc``, default its dtype) and the rank's block kept (a
    reduce-scatter)."""
    return (_GatherPartial.apply(x, ctx, axes, dim, acc)
            if _active(ctx, axes) else x)


def gather_param(p: torch.Tensor, ctx: Optional[ShardCtx]) -> torch.Tensor:
    """A parameter as a layer computes with it: under ZeRO-3 (its ``z3``
    split) its blocks gathered over the zero3 axes, and in the backward the
    gradient summed over them in float32 and the rank's block kept (a
    reduce-scatter: each data rank's rows give a part of the gradient, so
    ``trainer.sync_grads`` sums it over no zero3 axis again); the result
    keeps the parameter's TP or EP ``shard``. Any other parameter is
    returned as it is."""
    split = getattr(p, "z3", None)
    if split is None:
        return p
    out = gather_partial(p, ctx, split.axes, split.dim, torch.float32)
    out.shard = getattr(p, "shard", None)
    return out


def exchange(x, ctx: Optional[ShardCtx], axes):
    """``all_to_all`` over ``axes`` (its own inverse in the backward)."""
    return _Exchange.apply(x, ctx, axes) if _active(ctx, axes) else x
