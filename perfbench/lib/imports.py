"""What a run may not have loaded: JAX, its libraries, or the JAX package
the port was made from. Names are compared whole by their top-level part
(the text before the first dot): ``repro_torch`` is the program and is
allowed, ``repro`` is not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules: Iterable[str] = None,
              banned: Iterable[str] = FORBIDDEN) -> List[str]:
    """The loaded module names whose top-level name is banned."""
    names = sys.modules if modules is None else modules
    banned = frozenset(banned)
    return sorted(m for m in names if m.split(".", 1)[0] in banned)
