"""Checkpoints in the JAX package's format (``repro.training.checkpoint``),
so that either package restores the other's.

One directory per step, ``step_XXXXXXXX/``, holding
  * ``manifest.json`` — ``step``, ``paths`` and ``dtypes`` of the leaves;
  * ``arrays.npz``    — the leaves ``a0 ... aN`` in JAX's flatten order of
    its ``TrainState``: ``.params/...``, then ``.opt/.step``,
    ``.opt/.m/...``, ``.opt/.v/...``, then ``.step``, dict keys sorted and
    each stacked layer's parameters on their ``count`` axis
    (``models.convert.jax_leaves``).
bfloat16 is stored as its uint16 bits with the dtype string
``"bfloat16"`` and read back as a view of those bits, so no ``ml_dtypes``
is needed. Writes are atomic (a temp dir, then a rename): a failure mid-
write never leaves a directory that ``latest_step`` would take.

A sharded state (parameters with a ``shard`` and, under ZeRO-3, a ``z3``
split: ``models.lm.Model`` under a mesh) is saved as its logical arrays, gathered to rank 0 one tensor at a
time as rank 0 writes them. A restore takes each rank's block of every
array, so a checkpoint moves between meshes, and between the port and the
JAX package.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import tempfile
import zipfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..launch.shardings import gather_to_root
from ..models.convert import jax_key, jax_path
from ..models.sharding import ShardCtx, shard_tensor, splits_of
from .optim import AdamWState
from .trainer import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _groups(tensors) -> List[Tuple[str, bool, List[Tuple[str, torch.Tensor]]]]:
    """(path, stacked, parts) of each JAX leaf of tensors named as the
    parameters, in JAX's flatten order (``models.convert.jax_leaves``):
    ``parts`` are (name, tensor) of a stacked leaf's layers in ``count``
    order, or of the one tensor."""
    groups: Dict[Tuple, Dict] = defaultdict(dict)
    for name, t in tensors.items():
        key, idx = jax_key(name)
        groups[key][idx] = (name, t)
    out = []
    for key in sorted(groups):
        g = groups[key]
        stacked = None not in g
        out.append((jax_path(key), stacked,
                    [g[i] for i in (sorted(g) if stacked else [None])]))
    return out


def _leaves(state: TrainState):
    """``_groups`` of every leaf of ``state`` in JAX's order of
    ``TrainState``; the steps are int32 scalars."""
    def step(s):
        return [("", torch.tensor(s, dtype=torch.int32))]
    out = [(".params/" + p, st, parts)
           for p, st, parts in _groups(state.params)]
    out.append((".opt/.step", False, step(state.opt.step)))
    for field, tensors in ((".opt/.m/", state.opt.m),
                           (".opt/.v/", state.opt.v)):
        out += [(field + p, st, parts) for p, st, parts in _groups(tensors)]
    out.append((".step", False, step(state.step)))
    return out


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int32: "int32", torch.float16: "float16"}


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """npz holds no bfloat16: its bits as uint16, named ``"bfloat16"``."""
    name = _DTYPE_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _shards(state: TrainState):
    return {n: splits_of(p) for n, p in state.params.items()}


def save_checkpoint(directory: str, step: int, state: TrainState,
                    ctx: Optional[ShardCtx] = None) -> str:
    """Write ``state`` as ``step_XXXXXXXX`` under ``directory``, one tensor
    at a time, each stacked leaf layer by layer into its ``.npy`` entry.
    Under a mesh (``ctx``) every rank calls it: each logical tensor is
    gathered to rank 0 alone (``launch.shardings.gather_to_root``), which
    writes it before the next comes, so no rank holds more than one
    logical tensor beyond its shards; every rank returns once the step is
    written."""
    final = os.path.join(directory, f"step_{step:08d}")
    mesh = None if ctx is None else ctx.mesh
    shards = _shards(state)
    writes = mesh is None or mesh.rank == 0

    def fetch(name, t):
        if mesh is None:
            return t.detach().cpu()
        return gather_to_root(t, shards.get(name), ctx)

    tmp = None
    if writes:
        os.makedirs(directory, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        paths, dtypes = [], []
        with (zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                              zipfile.ZIP_STORED, allowZip64=True)
              if writes else contextlib.nullcontext()) as zf:
            for i, (path, stacked, parts) in enumerate(_leaves(state)):
                paths.append(path)
                arrays = (fetch(name, t) for name, t in parts)
                if not writes:              # a part of the gathers only
                    for _ in arrays:
                        pass
                    continue
                first, dtype = _to_savable(next(arrays))
                dtypes.append(dtype)
                with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": np.lib.format.dtype_to_descr(first.dtype),
                        "fortran_order": False,
                        "shape": ((len(parts),) if stacked else ())
                        + first.shape})
                    for a in itertools.chain(
                            [first], (_to_savable(b)[0] for b in arrays)):
                        f.write(np.ascontiguousarray(a).reshape(-1)
                                .view(np.uint8).data)
        if writes:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "paths": paths, "dtypes": dtypes}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
    except Exception:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    if mesh is not None:
        dist.barrier()
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest step with a complete manifest, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            s = int(name.split("_")[1])
            best = s if best is None else max(best, s)
    return best


def _from_saved(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"checkpoint leaf of {a.dtype} named {dtype}")
    return torch.from_numpy(a.copy())


def restore_checkpoint(directory: str, step: int, like: TrainState
                       ) -> TrainState:
    """Restore into the tensors of ``like`` (copied in place, cast to each
    tensor's dtype, as JAX casts to its ``like``; each rank's block of a
    sharded one) and return the state with the saved steps. The manifest's
    paths must be those of ``like``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = [p for p, _, _ in _leaves(like)]
    if manifest["paths"] != want:
        raise ValueError(
            f"checkpoint {path} has {len(manifest['paths'])} leaves that "
            f"differ from the {len(want)} expected (first expected: "
            f"{want[:3]})")
    data = np.load(os.path.join(path, "arrays.npz"))
    saved = {p: _from_saved(data[f"a{i}"], d) for i, (p, d) in
             enumerate(zip(manifest["paths"], manifest["dtypes"]))}
    shards = _shards(like)
    for prefix, tensors in ((".params/", like.params),
                            (".opt/.m/", like.opt.m),
                            (".opt/.v/", like.opt.v)):
        for name, t in tensors.items():
            key, idx = jax_key(name)
            leaf = saved[prefix + jax_path(key)]
            leaf = shard_tensor(leaf if idx is None else leaf[idx],
                                shards[name])
            with torch.no_grad():
                t.copy_(leaf)
    opt = AdamWState(int(saved[".opt/.step"]), like.opt.m, like.opt.v)
    return TrainState(like.params, opt, int(saved[".step"]))
