"""The sharding context (the JAX package's ``ShardCtx``) over
``torch.distributed``, and the collectives the sharded blocks run.

Mesh axes are ``("data", "model")`` (``launch.mesh.make_mesh_for``):

  * batch rows            -> "data"   (data parallelism, DP)
  * attention heads, d_ff,
    the vocab             -> "model"  (tensor parallelism, TP)
  * the expert bank       -> ``ep_axes``: ("model",) or ("data", "model")
                             (expert parallelism, EP)

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
           "shard_tensor", "all_reduce", "all_gather", "gather_to_first",
           "all_to_all",
           "copy_to", "reduce_from", "gather_from", "scatter_to",
           "gather_partial", "exchange"]

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


def shard_tensor(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """The rank's block of the logical ``t`` (``t`` itself when not
    split)."""
    if split is None:
        return t
    n = t.shape[split.dim] // split.parts
    return t.narrow(split.dim, split.index * n, n)


@dataclass
class EPStats:
    """What the expert-parallel MoE layers did since the counters were last
    zeroed: the (token, expert) pairs dropped past the capacity (a 0-dim
    device tensor, summed without a host read), the ``all_to_all`` calls
    and the bytes a rank sent to the others through them, and the branch
    each call took."""
    dropped: Any = 0
    pairs: int = 0
    a2a_calls: int = 0
    a2a_bytes: int = 0
    branches: dict = field(default_factory=dict)

    def zero(self) -> None:
        self.dropped, self.pairs, self.a2a_calls, self.a2a_bytes = 0, 0, 0, 0
        self.branches = {}


@dataclass
class ShardCtx:
    """Carries the mesh and the axis names through model construction.

    ``mesh=None`` is the single-device model. ``mesh`` is a
    ``launch.mesh.Mesh`` (its ``shape`` by axis name, the rank's
    coordinates and a process group per axis tuple). ``ep_axes`` selects
    the expert-parallel axes: ("model",) is classic EP within TP,
    ("data", "model") spreads the experts over every rank.

    ``zero3`` and ``kv_seq_shard`` are not ported: setting either raises.
    """

    mesh: Optional[Any] = None
    batch_axes: Axes = ("data",)
    model_axis: str = "model"
    ep_axes: Axes = ("model",)
    #: heads are padded to a multiple of this whatever the live mesh, so the
    #: parameter layout is mesh-independent
    head_pad: int = HEAD_PAD
    zero3: bool = False
    kv_seq_shard: bool = False
    stats: EPStats = field(default_factory=EPStats)

    def __post_init__(self):
        for flag in ("zero3", "kv_seq_shard"):
            if getattr(self, flag):
                raise NotImplementedError(
                    f"ShardCtx({flag}=True) is not ported yet (ROADMAP "
                    "queue 1 #8)")

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


# ------------------------------------------------------------- collectives
def _active(ctx: Optional[ShardCtx], axes) -> bool:
    return ctx is not None and ctx.size(axes) > 1


def _axes(axes) -> Axes:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _staged(ctx: ShardCtx, t: torch.Tensor) -> bool:
    """gloo takes host tensors: a CUDA tensor goes through host memory."""
    return ctx.mesh.backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, ctx: Optional[ShardCtx], axes,
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``t`` over the ranks of ``axes``, as a
    new tensor."""
    if not _active(ctx, axes):
        return t
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
    staged = _staged(ctx, t)
    src = t.detach().to("cpu" if staged else t.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(ctx.size(axes))]
    dist.all_gather(parts, src, group=ctx.mesh.group(_axes(axes)))
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out


def gather_to_first(t: torch.Tensor, ctx: ShardCtx, axes, dim: int
                    ) -> Optional[torch.Tensor]:
    """The ranks' ``t`` over ``axes`` concatenated along ``dim`` on the
    group's first rank (row-major), None on the others."""
    if not _active(ctx, axes):
        return t
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
    def forward(fctx, x, ctx, axes, dim):
        fctx.args = (ctx, axes, dim)
        return all_gather(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim = fctx.args
        return (_block(all_reduce(g, ctx, axes), ctx, axes, dim)
                .contiguous(), None, None, None)


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


def gather_partial(x, ctx: Optional[ShardCtx], axes, dim: int):
    """The ranks' ``x`` joined along ``dim`` into an input of which every
    rank computes a partial result: the gradient is summed over ``axes``
    and the rank's block kept."""
    return (_GatherPartial.apply(x, ctx, axes, dim) if _active(ctx, axes)
            else x)


def exchange(x, ctx: Optional[ShardCtx], axes):
    """``all_to_all`` over ``axes`` (its own inverse in the backward)."""
    return _Exchange.apply(x, ctx, axes) if _active(ctx, axes) else x
