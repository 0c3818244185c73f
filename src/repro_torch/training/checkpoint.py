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
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import jax_key, jax_leaves, jax_path
from .optim import AdamWState
from .trainer import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _flat(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """(path, CPU tensor) of every leaf, in JAX's order of ``TrainState``."""
    def step(s):
        return torch.tensor(s, dtype=torch.int32)
    out = [(".params/" + p, t) for p, t in
           jax_leaves(state.params, numpy=False)]
    out.append((".opt/.step", step(state.opt.step)))
    for field, tensors in ((".opt/.m/", state.opt.m),
                           (".opt/.v/", state.opt.v)):
        out += [(field + p, t) for p, t in jax_leaves(tensors, numpy=False)]
    out.append((".step", step(state.step)))
    return out


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int32: "int32", torch.float16: "float16"}


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """npz holds no bfloat16: its bits as uint16, named ``"bfloat16"``."""
    name = _DTYPE_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def save_checkpoint(directory: str, step: int, state: TrainState) -> str:
    leaves = _flat(state)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        savable = [_to_savable(t) for _, t in leaves]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, (a, _) in enumerate(savable)})
        manifest = {"step": step, "paths": [p for p, _ in leaves],
                    "dtypes": [d for _, d in savable]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
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
    tensor's dtype, as JAX casts to its ``like``) and return the state with
    the saved steps. The manifest's paths must be those of ``like``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = _layout(like)
    if manifest["paths"] != want:
        raise ValueError(
            f"checkpoint {path} has {len(manifest['paths'])} leaves that "
            f"differ from the {len(want)} expected (first expected: "
            f"{want[:3]})")
    data = np.load(os.path.join(path, "arrays.npz"))
    saved = {p: _from_saved(data[f"a{i}"], d) for i, (p, d) in
             enumerate(zip(manifest["paths"], manifest["dtypes"]))}
    for prefix, tensors in ((".params/", like.params),
                            (".opt/.m/", like.opt.m),
                            (".opt/.v/", like.opt.v)):
        for name, t in tensors.items():
            key, idx = jax_key(name)
            leaf = saved[prefix + jax_path(key)]
            with torch.no_grad():
                t.copy_(leaf if idx is None else leaf[idx])
    opt = AdamWState(int(saved[".opt/.step"]), like.opt.m, like.opt.v)
    return TrainState(like.params, opt, int(saved[".step"]))


def _layout(state: TrainState) -> List[str]:
    """The paths of ``_flat``, without copying a tensor."""
    def paths(prefix, tensors):
        return [prefix + jax_path(k)
                for k in sorted({jax_key(n)[0] for n in tensors})]
    return (paths(".params/", state.params) + [".opt/.step"]
            + paths(".opt/.m/", state.opt.m) + paths(".opt/.v/", state.opt.v)
            + [".step"])
