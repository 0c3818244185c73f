"""The dry run: every (arch x shape x mesh) cell of the JAX package's
production deployment, one rank's step on the ``meta`` device
(``repro.launch.dryrun``'s counterpart; no card, no process group).

Each cell (``launch.specs``) builds rank 0's shard of the model on a
``launch.mesh.DryMesh`` of the production mesh, (16, 16) over ("data",
"model") or (2, 16, 16) over ("pod", "data", "model"), and runs its step
once on meta tensors: nothing is allocated, no kernel runs (each kernel
wrapper returns its outputs' shapes, ``kernels.meta``), and each
collective records its call. Per cell this records, under the JAX dry
run's field names where a counterpart exists:
  * ``status``: ``ok``, ``skip`` (with the ``reason``) or ``fail`` (with
    the ``error``);
  * ``model_flops`` (6ND for train, 2ND for prefill, 2N a token for
    decode, as JAX's);
  * ``cost_analysis.flops``: the step's operations counted with the
    formulas of ``torch.utils.flop_counter.FlopCounterMode`` (its
    ``flop_registry``: products, convolutions, attention) plus each kernel
    call's own count (``kernels.meta.FLOPS``, by kernel in
    ``kernel_flops``);
  * ``input_bytes_per_device``: the rank's parameters, optimizer moments,
    caches and batch (JAX's ``analytic_input_bytes``; also as
    ``memory_analysis.argument_size_in_bytes``);
  * ``memory_analysis.temp_size_in_bytes``: the most bytes the step held
    live beyond its inputs, by a dispatch mode that follows every storage
    the step's operations make until it is freed (JAX's
    ``temp_size_in_bytes``);
  * ``collectives``: count and result bytes by kind (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``), as JAX's
    ``collective_bytes`` counts the partitioned HLO's;
  * ``notes``: what the meta device could not read (``launch.specs``).
JAX's ``--save-hlo`` and ``--unroll`` have no meaning here: there is no
HLO, and the layers are already a Python loop, so every layer's work is
counted.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
        [--arch qwen1.5-32b ...] [--shape train_4k ...] [--out experiments]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import meta
from .mesh import make_production_mesh
from .specs import Cell, build_cell, plan_cells

__all__ = ["StepCounter", "input_bytes", "run_cell", "main"]

MESHES = {"single": ("single_pod_16x16", False),
          "multi": ("multi_pod_2x16x16", True)}


class StepCounter(TorchDispatchMode):
    """What the operations under it do: their operations (``flops``, by
    ``FlopCounterMode``'s formulas; the flop counter itself keeps tensors
    alive through its module hooks, so its registry is read here), and the
    bytes of the meta storages they made that are still alive (``live``)
    and the most there were at once (``peak``). A storage is followed from
    the operation that made it until it is freed (a weak reference),
    whatever tensors view it; an operation's output on one of its inputs'
    storages (in place, a view) is not new, so storages made before the
    mode (the step's inputs) are never counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = self.peak = 0
        self._seen: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        inputs = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.device.type != "meta":
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._seen or key in inputs:
                continue
            self._seen[key] = s.nbytes()
            self.live += self._seen[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key)
        return out


def input_bytes(inputs: Dict[str, Any]) -> float:
    """The bytes of every tensor in the rank's inputs: its shards, and its
    rows of the batch (views of the global batch, each counted at its own
    size)."""
    tensors = {id(t): t for t in tree_leaves(inputs)
               if isinstance(t, torch.Tensor)}
    return float(sum(t.numel() * t.element_size() for t in tensors.values()))


def _mesh_label(mesh) -> str:
    return "x".join(f"{mesh.shape[a]}{a}" for a in mesh.names)


def run_cell(cell: Cell, mesh, cfg=None, **changes) -> Dict[str, Any]:
    """One cell's record (see the module's docstring); ``cfg`` and
    ``changes`` as ``specs.build_cell`` takes them."""
    rec: Dict[str, Any] = {"arch": cell.arch, "shape": cell.shape.name,
                           "kind": cell.kind, "mesh": _mesh_label(mesh)}
    if cell.skip:
        rec["status"] = "skip"
        rec["reason"] = cell.skip
        return rec
    t0 = time.time()
    try:
        cell = build_cell(cell, mesh, cfg, **changes)
        rec["input_bytes_per_device"] = input_bytes(cell.inputs)
        mesh.log.zero()
        meta.zero()
        with StepCounter() as counted:
            cell.fn(*cell.args)
        rec["status"] = "ok"
        rec["dry_s"] = round(time.time() - t0, 1)
        rec["model_flops"] = cell.model_flops
        rec["cost_analysis"] = {
            "flops": float(counted.flops) + sum(meta.FLOPS.values()),
            "kernel_flops": dict(meta.FLOPS)}
        rec["memory_analysis"] = {
            "argument_size_in_bytes": rec["input_bytes_per_device"],
            "temp_size_in_bytes": counted.peak}
        rec["collectives"] = mesh.log.as_dict()
        rec["notes"] = cell.notes
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json filename")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [MESHES[m] for m in (("single", "multi") if args.mesh == "both"
                                  else (args.mesh,))]
    for mesh_name, multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod, dry=True)
        results: List[Dict[str, Any]] = []
        for cell in plan_cells(args.arch, args.shape):
            rec = run_cell(cell, mesh)
            results.append(rec)
            status = rec["status"]
            if status == "ok":
                arg_gb = rec["input_bytes_per_device"] / 1e9
                tmp_gb = rec["memory_analysis"]["temp_size_in_bytes"] / 1e9
                col_gb = rec["collectives"]["total_bytes"] / 1e9
                extra = (f"args={arg_gb:.2f}GB/dev temp={tmp_gb:.2f}GB "
                         f"coll={col_gb:.3f}GB dry={rec['dry_s']}s")
            elif status == "fail":
                extra = rec["error"][:120]
            else:
                extra = rec["reason"][:60]
            print(f"[{mesh_name}] {cell.arch:22s} {cell.shape.name:12s} "
                  f"{status:4s} {extra}", flush=True)
        path = os.path.join(args.out, f"dryrun_{mesh_name}{args.tag}.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        ok = sum(r["status"] == "ok" for r in results)
        skip = sum(r["status"] == "skip" for r in results)
        fail = sum(r["status"] == "fail" for r in results)
        print(f"[{mesh_name}] done: {ok} ok / {skip} skip / {fail} fail "
              f"-> {path}", flush=True)


if __name__ == "__main__":
    main()
