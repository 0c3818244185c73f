"""Settings of a published model that the JAX package's ``ArchConfig`` has
no field for, kept on the port's side: ``configs/base.py`` is a byte copy
of the JAX package's file.

``PortArch`` is an ``ArchConfig`` with one more field, ``port``
(``PortSettings``); every block reads it through ``settings(cfg)``, which
gives the defaults for a plain ``ArchConfig``. The defaults build every
model exactly as the JAX package does: the softmax router, every expert
held, plain RoPE. DeepSeek-V3 as published sets the rest:

* ``router="sigmoid_group"``: sigmoid scores over every expert plus a
  per-expert correction bias (``MoE.router_bias``), a group's score the
  sum of its two best biased scores, the ``topk_group`` best groups kept,
  the ``top_k`` best biased scores among their experts chosen, and each
  chosen expert's gate its unbiased score over the chosen ones' sum, times
  ``routed_scale`` (DeepSeek-V3's ``noaux_tc``, ``norm_topk_prob``);
* ``held=(lo, n)``: the layer holds experts ``[lo, lo + n)`` of
  ``n_experts`` (a chip's share under expert parallelism), routes over all
  of them and computes its own experts' part;
* ``yarn``: YaRN on the rope dims of MLA (``Yarn``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig

__all__ = ["Yarn", "PortSettings", "PortArch", "settings", "held_experts"]


def _mscale(factor: float, m: float) -> float:
    """YaRN's attention scale of a context stretched ``factor`` times."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


@dataclass(frozen=True)
class Yarn:
    """YaRN (arXiv:2309.00071) as DeepSeek-V3's ``rope_scaling`` sets it:
    the rope frequencies of dims below ``low`` as they are, those above
    ``high`` divided by ``factor``, a linear ramp between; ``low`` and
    ``high`` are where a dim turns ``beta_fast`` and ``beta_slow`` times
    over the ``original`` positions."""

    factor: float
    original: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0

    def bounds(self, dim: int, base: float) -> Tuple[int, int]:
        """(low, high) over the ``dim // 2`` frequencies, clamped to them."""
        def at(turns):
            return (dim * math.log(self.original / (turns * 2 * math.pi))
                    / (2 * math.log(base)))
        low = max(math.floor(at(self.beta_fast)), 0)
        high = min(math.ceil(at(self.beta_slow)), dim - 1)
        return low, high

    def inv_freq(self, dim: int, base: float, device=None) -> torch.Tensor:
        """The ``dim // 2`` float32 frequencies."""
        half = dim // 2
        i = torch.arange(half, dtype=torch.float32, device=device)
        extra = 1.0 / (base ** (i / half))
        low, high = self.bounds(dim, base)
        ramp = ((i - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
        return extra / self.factor * ramp + extra * (1.0 - ramp)

    @property
    def rope_scale(self) -> float:
        """The factor on the cos and sin tables (1 where ``mscale`` equals
        ``mscale_all_dim``, as DeepSeek-V3 sets them)."""
        return (_mscale(self.factor, self.mscale)
                / _mscale(self.factor, self.mscale_all_dim))

    @property
    def softmax_scale(self) -> float:
        """The factor on attention's ``1 / sqrt(head dim)``:
        ``mscale_all_dim``'s scale squared (1.8738 at factor 40)."""
        return _mscale(self.factor, self.mscale_all_dim) ** 2


@dataclass(frozen=True)
class PortSettings:
    router: str = "softmax"           # or "sigmoid_group"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    held: Tuple[int, int] = (0, 0)    # (first expert, count); 0: all
    yarn: Optional[Yarn] = None


DEFAULT = PortSettings()


@dataclass(frozen=True)
class PortArch(ArchConfig):
    port: PortSettings = DEFAULT


def settings(cfg: ArchConfig) -> PortSettings:
    return getattr(cfg, "port", DEFAULT)


def held_experts(cfg: ArchConfig) -> Tuple[int, int]:
    """(first, count) of the experts a layer holds: every one by default."""
    lo, n = settings(cfg).held
    return (lo, n) if n else (0, cfg.n_experts)
