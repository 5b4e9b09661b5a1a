"""Box projection: clamp each coordinate to ``[lower, upper]``
(``dualip_tpu/projections/box.py``).

Accepts the ``l``/``u`` and ``lower``/``upper`` spellings, defaults to
``[0, 1]``, and reads a NaN bound as absent (a one-sided box).
"""

from __future__ import annotations

import math

import torch

from dualip_tpu_torch.projections.base import ProjectionOperator, register


def _resolve(alias_short, alias_long, default):
    if alias_short is not None and alias_long is not None:
        raise ValueError("Specify either the short ('l'/'u') or long ('lower'/'upper') key, not both")
    val = alias_short if alias_short is not None else alias_long
    if val is None:
        return default
    if isinstance(val, float) and math.isnan(val):
        return None  # NaN bound == no bound on that side
    return val


def clamp(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """``max`` with ``lower`` then ``min`` with ``upper``; ``None`` skips a side."""
    if lower is not None:
        x = torch.maximum(x, torch.full((), lower, dtype=x.dtype, device=x.device))
    if upper is not None:
        x = torch.minimum(x, torch.full((), upper, dtype=x.dtype, device=x.device))
    return x


@register("box")
class BoxProjection(ProjectionOperator):
    def __init__(self, lower=None, upper=None, l=None, u=None):  # noqa: E741 - schema parity
        self.lower = _resolve(l, lower, 0.0)
        self.upper = _resolve(u, upper, 1.0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return clamp(x, self.lower, self.upper)
