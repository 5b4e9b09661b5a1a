"""Box-cut projection: box ``[l, u]^L`` intersected with a sum cut
(``dualip_tpu/projections/box_cut.py``).

``x*(nu) = clip(v - nu, l, u)`` with the scalar shift ``nu`` found by a
fixed-trip bisection on ``[min(v) - u, max(v) - l]``; for the inequality
variant, columns with ``sum clip(v, l, u) <= z`` pass through.
"""

from __future__ import annotations

import torch

from dualip_tpu_torch.projections.base import ProjectionOperator, register
from dualip_tpu_torch.projections.box import _resolve

BISECTION_ITERS = 50


def _clip(x, lt, ut):
    return torch.minimum(torch.maximum(x, lt), ut)


def box_cut_project(
    x: torch.Tensor,
    lower: float,
    upper: float,
    z: float,
    inequality: bool = False,
    tol: float = 1e-6,
    max_iter: int = BISECTION_ITERS,
) -> torch.Tensor:
    """Project each last-axis vector onto ``{l <= w <= u, sum w (<=|=) z}``."""
    dtype, dev = x.dtype, x.device
    lt = torch.full((), lower, dtype=dtype, device=dev)
    ut = torch.full((), upper, dtype=dtype, device=dev)
    zt = torch.full((), z, dtype=dtype, device=dev)

    lo = torch.amin(x, dim=-1) - ut
    hi = torch.amax(x, dim=-1) - lt
    for _ in range(max_iter):
        mid = (lo + hi) * 0.5
        too_high = torch.sum(_clip(x - mid[..., None], lt, ut), dim=-1) > zt
        lo, hi = torch.where(too_high, mid, lo), torch.where(too_high, hi, mid)
    nu = (lo + hi) * 0.5
    w = _clip(x - nu[..., None], lt, ut)

    if inequality:
        clipped = _clip(x, lt, ut)
        feasible = torch.sum(clipped, dim=-1) <= zt + torch.full((), tol, dtype=dtype, device=dev)
        w = torch.where(feasible[..., None], clipped, w)
    return w


class _BoxCutBase(ProjectionOperator):
    _inequality: bool

    def __init__(self, lower=None, upper=None, l=None, u=None, z: float = 1.0, method: str = "bisection_search"):  # noqa: E741 - schema parity
        self.lower = _resolve(l, lower, 0.0)
        self.upper = _resolve(u, upper, 1.0)
        if self.lower is None or self.upper is None:
            raise ValueError(
                "box_cut needs finite lower AND upper bounds (use simplex/cone for one-sided sets)"
            )
        if self.lower > self.upper:
            raise ValueError(f"box_cut bounds must satisfy lower <= upper (got {self.lower} > {self.upper})")
        if method != "bisection_search":
            raise ValueError(f"Unsupported projection method: {method}")
        self.z = z

    def _check_feasible(self, L: int):
        lo, hi = L * self.lower, L * self.upper
        if self._inequality:
            if self.z < lo:
                raise ValueError(f"Empty box_cut polytope: z={self.z} < L*lower={lo} (L={L})")
        elif not (lo <= self.z <= hi):
            raise ValueError(
                f"Empty box_cut_eq polytope: z={self.z} outside [L*lower, L*upper]=[{lo}, {hi}] (L={L})"
            )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check_feasible(x.shape[-1])
        return box_cut_project(x, self.lower, self.upper, self.z, inequality=self._inequality)


@register("box_cut")
class BoxCutIneq(_BoxCutBase):
    """Projection onto ``{lower <= w <= upper, sum w <= z}``."""

    _inequality = True


@register("box_cut_eq")
class BoxCutEq(_BoxCutBase):
    """Projection onto ``{lower <= w <= upper, sum w = z}``."""

    _inequality = False
