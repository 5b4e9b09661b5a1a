"""One-sided cone projection and the identity
(``dualip_tpu/projections/cone.py``)."""

from __future__ import annotations

import torch

from dualip_tpu_torch.projections.base import ProjectionOperator, register
from dualip_tpu_torch.projections.box import _resolve, clamp


@register("cone")
class ConeProjection(ProjectionOperator):
    """``[lower, +inf)`` or ``(-inf, upper]``; neither bound is the identity."""

    def __init__(self, lower=None, upper=None, l=None, u=None):  # noqa: E741 - schema parity
        self.lower = _resolve(l, lower, None)
        self.upper = _resolve(u, upper, None)
        if self.lower is not None and self.upper is not None:
            raise ValueError("Only one of 'lower' or 'upper' should be specified, not both.")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return clamp(x, self.lower, self.upper)


@register("identity")
class IdentityProjection(ProjectionOperator):
    """No constraint on the block (columns no projection entry covers)."""

    def __init__(self):
        pass

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x
