"""The JAX package's parameter pytree and the PyTorch model's parameters,
both ways.

The JAX tree (``repro.models.lm.Model.init``), given as numpy arrays, maps
name for name onto the port's parameters; each segment's ``vmap``-stacked
leading ``count`` axis is unstacked into the segment's ``count`` blocks,
and so are the stacked layers of ``encoder`` and ``mtp_layer``
(``from_jax_params``). ``to_jax_tree`` restacks them: the port's
parameters, or any tensors named as they are (gradients, optimizer
moments), in the JAX pytree's nesting; ``jax_leaves`` gives the same
leaves in JAX's flatten order with their paths, as ``jax.tree_util``
names them.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterator, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from .lm import Model

__all__ = ["from_jax_params", "to_jax_tree", "jax_leaves", "jax_key",
           "jax_path", "jax_ndim"]


def _walk(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def from_jax_params(params: Any, model: Model) -> Model:
    """Copy ``params`` (the JAX pytree with numpy leaves) into ``model``,
    cast to each parameter's dtype and device; a sharded model takes its
    rank's block of each leaf (``Split``). Strict: every parameter of the
    model must be set and every leaf used."""
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
        name = ".".join(str(p) for p in path)
        if str(path[0]).startswith("seg"):
            # (seg, sublayer, ...) leaf [count, ...] -> seg.<c>.<sublayer>...
            seg, sub, rest = path[0], path[1], ".".join(map(str, path[2:]))
            for c in range(arr.shape[0]):
                state[f"{seg}.{c}.{sub}.{rest}"] = arr[c]
        elif path[0] in ("encoder", "mtp_layer"):
            # (stack, ...) leaf [count, ...] -> stack.<c>...
            rest = ".".join(map(str, path[1:]))
            for c in range(arr.shape[0]):
                state[f"{path[0]}.{c}.{rest}"] = arr[c]
        else:
            state[name] = arr
    own = model.state_dict()
    missing, extra = own.keys() - state.keys(), state.keys() - own.keys()
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    from ..launch.shardings import model_splits, shard_state
    state = shard_state(state, model_splits(model))
    model.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()})
    return model


def jax_key(name: str) -> Tuple[Tuple[Union[str, int], ...], Any]:
    """A port parameter's place in the JAX pytree: (the leaf's key path,
    its index on the leaf's stacked ``count`` axis, or None for a leaf that
    is not stacked). ``seg0.3.1.mix.wq.w`` -> (("seg0", 1, "mix", "wq",
    "w"), 3); ``encoder.2.ln1.g`` -> (("encoder", "ln1", "g"), 2);
    ``ln_f.g`` -> (("ln_f", "g"), None)."""
    parts = name.split(".")
    if parts[0].startswith("seg"):
        return (parts[0], int(parts[2]), *parts[3:]), int(parts[1])
    if parts[0] in ("encoder", "mtp_layer"):
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def jax_path(key: Tuple[Union[str, int], ...]) -> str:
    """A key path as ``jax.tree_util`` prints it: ``"/".join(str(k))`` of
    its dict keys (``['mix']``) and list indices (``[0]``)."""
    return "/".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                    for k in key)


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of the JAX leaf that holds ``t``: one more for a stacked
    layer's parameter (its ``count`` axis)."""
    return t.dim() + (jax_key(name)[1] is not None)


def _tensors(model_or_tensors) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_tensors, nn.Module):
        return dict(model_or_tensors.named_parameters())
    return model_or_tensors


def _stacked(model_or_tensors, numpy: bool):
    """(key path, leaf) of each JAX leaf, in JAX's flatten order (sorted
    key paths: at each level the keys are all dict keys or all list
    indices, as in the pytree)."""
    groups: Dict[Tuple, Dict[Any, torch.Tensor]] = defaultdict(dict)
    for name, t in _tensors(model_or_tensors).items():
        key, idx = jax_key(name)
        groups[key][idx] = t.detach()
    for key in sorted(groups):
        parts = groups[key]
        leaf = (parts[None].cpu() if None in parts else
                torch.stack([parts[c].cpu() for c in range(len(parts))]))
        if numpy:
            leaf = (leaf.float() if leaf.dtype == torch.bfloat16
                    else leaf).numpy()
        yield key, leaf


def jax_leaves(model_or_tensors, *, numpy: bool = True
               ) -> List[Tuple[str, Any]]:
    """(path, leaf) in JAX's flatten order of the parameter pytree: dict
    keys sorted, the segments' sublayer lists in order; each stacked leaf
    is its ``count`` tensors stacked on a new leading axis. Paths are
    ``jax.tree_util``'s ``"/".join(str(k) ...)``, e.g. ``['seg0']/[0]/
    ['mix']/['wq']/['w']``. Leaves are numpy arrays (bfloat16 as float32,
    which holds it exactly) with ``numpy``, else CPU tensors."""
    return [(jax_path(key), leaf)
            for key, leaf in _stacked(model_or_tensors, numpy)]


def _child(node, k, empty):
    """``node[k]`` of a dict or a list, made ``empty`` when absent."""
    if isinstance(node, list):
        node.extend([None] * (k + 1 - len(node)))
        if node[k] is None:
            node[k] = empty
        return node[k]
    return node.setdefault(k, empty)


def to_jax_tree(model_or_tensors) -> Dict[str, Any]:
    """The inverse of ``from_jax_params``: the model's parameters (or
    tensors named as its parameters) in the JAX pytree's nesting, dicts of
    dicts with each segment a list of its sublayers, stacked on ``count``,
    as numpy arrays (bfloat16 as float32)."""
    tree: Dict[str, Any] = {}
    for key, leaf in _stacked(model_or_tensors, numpy=True):
        node = tree
        for k, nxt in zip(key[:-1], key[1:]):
            node = _child(node, k, [] if isinstance(nxt, int) else {})
        node[key[-1]] = leaf                # a leaf's name is a dict key
    return tree
