"""Batched simplex projections (``dualip_tpu/projections/simplex.py``).

Two algorithms, both branch-free over the last axis of ``(..., L)`` blocks:

* ``duchi`` (default): sort, cumsum, rho threshold, theta (Duchi et al. 2008);
  float32 CUDA rows of at most 64 lanes go to one hand-written kernel
  (``ops/simplex_project.py``), everything else to torch's ops;
* ``bisection_search``: 50 fixed bisection steps on the shift ``nu``.

Both pre-clamp to ``x >= 0`` and keep the top-2 vertex shortcut
(``max > second_max + z`` gives the one-hot vertex) and, for the inequality
variant, pass already-feasible columns through.
"""

from __future__ import annotations

import torch

from dualip_tpu_torch.ops import simplex_project as _sortscan
from dualip_tpu_torch.projections.base import ProjectionOperator, register
from dualip_tpu_torch.utils import profiling


def _lane(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], device=x.device)


def _top2_last(x: torch.Tensor):
    """(max, second_max, argmax) along the last axis; argmax takes the first max."""
    v0 = torch.amax(x, dim=-1)
    i0 = torch.argmax(x, dim=-1)
    masked = torch.where(_lane(x) == i0[..., None], torch.full((), -torch.inf, dtype=x.dtype, device=x.device), x)
    v1 = torch.amax(masked, dim=-1)
    return v0, v1, i0


def _one_hot_vertex(x: torch.Tensor, i0: torch.Tensor, z) -> torch.Tensor:
    zt = torch.full((), z, dtype=x.dtype, device=x.device)
    return torch.where(_lane(x) == i0[..., None], zt, torch.zeros((), dtype=x.dtype, device=x.device))


def duchi_project(x: torch.Tensor, z: float = 1.0, inequality: bool = False, tol: float = 1e-6) -> torch.Tensor:
    """Project each last-axis vector onto ``{w >= 0, sum w (<=|=) z}``.

    Rows the sort-and-scan kernel takes (``ops/simplex_project.py::takes_kernel``:
    CUDA, float32, at most 64 lanes) go to it; the rest run torch's ops, and
    off the CPU count their rows in ``dualip.projections.duchi.torch_rows``
    (how often the kernel does not engage on the card)."""
    if _sortscan.takes_kernel(x.device, x.dtype, x.shape[-1]):
        return _sortscan.simplex_project(x, z, inequality, tol)
    if x.device.type != "cpu":
        profiling.count("dualip.projections.duchi.torch_rows", x.numel() // max(x.shape[-1], 1))
    return _duchi_torch(x, z, inequality, tol)


def _duchi_torch(x: torch.Tensor, z: float, inequality: bool, tol: float) -> torch.Tensor:
    """``duchi_project`` in torch's batched ops (sort, cumsum, sum)."""
    dtype, dev = x.dtype, x.device
    L = x.shape[-1]
    zt = torch.full((), z, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    x = torch.maximum(x, zero)

    u = torch.sort(x, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1)
    idx0 = _lane(x)
    idx1 = (idx0 + 1).to(dtype)
    cond = u - (css - zt) / idx1 > 0
    rho = torch.amax(torch.where(cond, idx0, 0), dim=-1)
    css_at_rho = torch.take_along_dim(css, rho[..., None], dim=-1)[..., 0]
    theta = (css_at_rho - zt) / (rho.to(dtype) + 1)
    w = torch.maximum(x - theta[..., None], zero)

    if L > 1:
        v0, v1, i0 = _top2_last(x / zt)
        shortcut = (v0 - v1) > 1.0
        w = torch.where(shortcut[..., None], _one_hot_vertex(x, i0, z), w)

    if inequality:
        feasible = torch.sum(x, dim=-1) <= zt + torch.full((), tol, dtype=dtype, device=dev)
        w = torch.where(feasible[..., None], x, w)
    return w


def bisection_project(
    x: torch.Tensor,
    z: float = 1.0,
    inequality: bool = False,
    tol: float = 1e-6,
    max_iter: int = 50,
) -> torch.Tensor:
    """Bisection-search simplex projection, anchored to ``duchi_project``'s
    semantics (pre-clamp; the inequality test is the sum test)."""
    dtype, dev = x.dtype, x.device
    L = x.shape[-1]
    zt = torch.full((), z, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    x = torch.maximum(x, zero)

    xn = x / zt
    x_max = torch.amax(xn, dim=-1, keepdim=True)
    x_shifted = xn - x_max

    lo = torch.full(x.shape[:-1], -1.0, dtype=dtype, device=dev)
    hi = torch.zeros(x.shape[:-1], dtype=dtype, device=dev)
    for _ in range(max_iter):
        mid = (lo + hi) * 0.5
        s = torch.sum(torch.maximum(x_shifted - mid[..., None], zero), dim=-1)
        too_high = s > 1.0
        lo, hi = torch.where(too_high, mid, lo), torch.where(too_high, hi, mid)
    nu = (lo + hi) * 0.5
    w = torch.maximum(x_shifted - nu[..., None], zero) * zt

    if L > 1:
        v0, v1, i0 = _top2_last(xn)
        shortcut = (v0 - v1) > 1.0
        w = torch.where(shortcut[..., None], _one_hot_vertex(x, i0, z), w)

    if inequality:
        feasible = torch.sum(x, dim=-1) <= zt + torch.full((), tol, dtype=dtype, device=dev)
        w = torch.where(feasible[..., None], x, w)
    return w


class _SimplexBase(ProjectionOperator):
    _inequality: bool

    def __init__(self, z: float = 1.0, method: str = "duchi"):
        if z <= 0:
            raise ValueError("Simplex radius z must be positive.")
        if method not in ("duchi", "bisection_search"):
            raise ValueError(f"Unsupported projection method: {method}")
        self.z = z
        self.proj_method = method

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        fn = bisection_project if self.proj_method == "bisection_search" else duchi_project
        return fn(x, z=self.z, inequality=self._inequality)


@register("simplex")
class SimplexIneq(_SimplexBase):
    """Projection onto ``{w >= 0, sum w <= z}``."""

    _inequality = True


@register("simplex_eq")
class SimplexEq(_SimplexBase):
    """Projection onto ``{w >= 0, sum w = z}``."""

    _inequality = False
