"""Meshes over ``torch.distributed`` (``repro.launch.mesh``'s
counterpart): the process group's ranks laid out row-major on a grid of
named axes (``("data", "model")``, or the multi-pod ``("pod", "data",
"model")``), as ``jax.make_mesh`` lays out devices, with a process group
for each tuple of axes.

    init_distributed(device="cpu")           # RANK / WORLD_SIZE from torchrun
    mesh = make_mesh_for(world_size, model_par=2)
    ctx = ShardCtx(mesh=mesh)

``make_production_mesh`` lays a group of 256 or 512 ranks out as the JAX
package's production meshes, (16, 16) over ("data", "model") and (2, 16,
16) over ("pod", "data", "model"); ``DryMesh`` is one rank's coordinates
on such a grid with no process group (``backend`` "dry"), on which the
collectives of ``models.sharding`` only record their calls: the dry run
(``launch.dryrun``) runs a rank's step on it.

The backend follows the device: ``nccl`` for CUDA, ``gloo`` for the CPU; a
caller may name one (gloo with CUDA tensors stages each collective through
host memory, ``models.sharding``). ``spawn`` starts ranks as processes of
this host and returns what each returned, re-raising any rank's failure:
the sharded tests and ``chip_smoke.py`` start their ranks through it.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

from ..models.sharding import CollectiveLog

__all__ = ["Mesh", "DryMesh", "make_mesh_for", "make_production_mesh",
           "init_distributed", "spawn"]

AXES = ("data", "model")

#: the JAX package's production meshes (``repro.launch.mesh``)
PRODUCTION = {False: ((16, 16), AXES),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    """The ranks of the default process group on a row-major grid:
    ``shape`` maps each axis name to its size, ``coord(axis)`` is this
    rank's coordinate, ``group(axes)`` the process group of the ranks that
    differ from this one only along ``axes`` (for axes of more than one
    rank; every rank creates every group, in one order, as
    ``torch.distributed.new_group`` requires); ``log`` the collectives run
    over it (``models.sharding.CollectiveLog``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES):
        world = dist.get_world_size()
        self._place(shape, axis_names, world, dist.get_rank())
        self.backend = dist.get_backend()
        grid = torch.arange(world).reshape(tuple(shape))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for r in range(1, len(self.names) + 1):
            for axes in itertools.combinations(self.names, r):
                if self.size(axes) > 1:
                    self._make_groups(grid, axes)

    def _place(self, shape, axis_names, world: int, rank: int) -> None:
        """The grid's sizes by name and ``rank``'s coordinates on it."""
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        if math.prod(shape) != world:
            raise ValueError(f"mesh {tuple(shape)} over {world} ranks")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.names = tuple(axis_names)
        self.rank = rank
        self._coords = {}
        for a, n in zip(reversed(self.names), reversed(tuple(shape))):
            self._coords[a], rank = rank % n, rank // n
        self.log = CollectiveLog()

    def _make_groups(self, grid: torch.Tensor, axes: Tuple[str, ...]):
        keep = [self.names.index(a) for a in axes]
        rest = [i for i in range(len(self.names)) if i not in keep]
        # rows of the grid with the other axes fixed, ranks row-major
        rows = grid.permute(rest + keep).reshape(-1, self.size(axes))
        for ranks in rows.tolist():
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[axes] = g

    def size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axes: Sequence[str]):
        return self._groups[tuple(axes)]

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.shape}, rank {self.rank} at "
                f"{self._coords}, {self.backend})")


class DryMesh(Mesh):
    """Rank ``rank``'s place on a grid of ``shape`` over ``axis_names``,
    with no process group: ``backend`` is "dry", and the collectives of
    ``models.sharding`` record their calls in ``log`` and return
    uninitialised results (the dry run's mesh, ``launch.dryrun``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES,
                 rank: int = 0):
        self._place(shape, axis_names, math.prod(shape), rank)
        self.backend = "dry"

    def group(self, axes: Sequence[str]):
        raise RuntimeError("a dry mesh has no process group")


def make_mesh_for(n_devices: int, model_par: int = 1) -> Mesh:
    """``(n_devices // model_par, model_par)`` over ``("data", "model")``,
    on the process group this rank runs in (``init_distributed``)."""
    if n_devices % model_par:
        raise ValueError(f"model_par {model_par} does not divide "
                         f"{n_devices} ranks")
    return Mesh((n_devices // model_par, model_par))


def make_production_mesh(*, multi_pod: bool = False,
                         dry: bool = False) -> Mesh:
    """The JAX package's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``, on the
    process group this rank runs in, which must have 256 or 512 ranks.
    With ``dry``, rank 0's ``DryMesh`` on it (no group: the dry run's)."""
    shape, names = PRODUCTION[multi_pod]
    if dry:
        return DryMesh(shape, names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"production mesh {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return Mesh(shape, names)


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None, *, device=None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the default process group: ``rank`` and ``world_size`` given,
    or read from ``RANK`` / ``WORLD_SIZE`` (torchrun sets them, and
    ``MASTER_ADDR`` / ``MASTER_PORT`` for the default ``env://``). Returns
    the rank's device: ``device``, or the card ``LOCAL_RANK`` under
    torchrun. The backend is ``backend``, else nccl on CUDA and gloo on the
    CPU."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return dev


def _rank_main(fn, rank, world, device, backend, init_method, args, out):
    try:
        dev = init_distributed(rank, world, device=device, backend=backend,
                               init_method=init_method)
        out.put((rank, True, fn(rank, dev, *args)))
    except BaseException:                   # reported to the parent
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Tuple = (), *, init_method: str,
          device="cpu", backend: Optional[str] = None,
          timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``world_size`` spawned processes
    joined in one process group (``init_method``: a ``file://`` path or a
    ``tcp://`` address) and return each rank's result (picklable; numpy
    arrays rather than tensors). A rank's exception is raised here with its
    traceback after every rank is stopped; so is a rank that exits without
    a result, or ``timeout`` seconds passing."""
    mp = torch.multiprocessing.get_context("spawn")
    out = mp.Queue()
    procs = [mp.Process(target=_rank_main, args=(
        fn, r, world_size, device, backend, init_method, args, out))
        for r in range(world_size)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    failure = None
    waited = 0.0
    try:
        while len(results) < world_size and failure is None:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    failure = f"rank {dead[0]} exited with code " \
                              f"{procs[dead[0]].exitcode} and no result"
                elif waited > timeout:
                    failure = f"ranks still running after {timeout} s"
                continue
            if ok:
                results[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn of {fn.__name__}: {failure}")
    return [results[r] for r in range(world_size)]
