"""Load the JAX package's parameter pytree into the PyTorch model.

The JAX tree (``repro.models.lm.Model.init``), given as numpy arrays, maps
name for name onto the port's parameters; each segment's ``vmap``-stacked
leading ``count`` axis is unstacked into the segment's ``count`` blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .lm import Model

__all__ = ["from_jax_params"]


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
    cast to each parameter's dtype and device. Strict: every parameter of
    the model must be set and every leaf used."""
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
        name = ".".join(str(p) for p in path)
        if str(path[0]).startswith("seg"):
            # (seg, sublayer, ...) leaf [count, ...] -> seg.<c>.<sublayer>...
            seg, sub, rest = path[0], path[1], ".".join(map(str, path[2:]))
            for c in range(arr.shape[0]):
                state[f"{seg}.{c}.{sub}.{rest}"] = arr[c]
        else:
            state[name] = arr
    own = model.state_dict()
    missing, extra = own.keys() - state.keys(), state.keys() - own.keys()
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    model.load_state_dict({k: v.to(own[k].dtype) for k, v in state.items()})
    return model
