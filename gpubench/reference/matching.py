"""Plain PyTorch reference of the matching LP's dual ascent.

It takes the generated CSC arrays, the budgets, gamma and the projection kind
as the benchmark made them, and works out everything else itself: its own
column groups, its own row sums, its own AGD state.  It imports nothing of
the program under test.

The dual objective of the gamma-regularised matching LP at ``lam`` is

    g(lam) = sum c.x + (gamma/2) |x|^2 + lam . (A x - b),
    x = argmin over the per-column sets of  c.x + (gamma/2)|x|^2 + lam . A x,

so each column's x is the Euclidean projection of ``z = -(a * lam[rows] + c)
/ gamma`` onto its set, and the gradient is ``A x - b``.  Every column here
carries one set: ``{x >= 0, sum x <= radius}`` (DuaLip's simplex inequality,
whose projection passes a clamped column through when its sum is at most
``radius + tol``).

One AGD call (DuaLip's accelerated gradient ascent) from ``lam0`` with a fresh
state: ``x = y = lam0``; per iteration the gradient at ``x``, a step from the
last ``history`` (gradient, y) pairs (``initial_step`` until the window is
full or when the estimate is not finite, else ``min(1 / L_max, max_step)``
with ``L_max`` the largest secant ratio ``|g_i+1 - g_i| / |y_i+1 - y_i|``),
``y' = max(x + step * g, 0)`` and ``x' = y' + beta_i (y - y')`` with FISTA's
``beta_i = (1 - t_i+1) / t_i+2``, ``t_0 = 0``, ``t_i+1 = (1 + sqrt(1 + 4
t_i^2)) / 2``.  The call returns the objective at each iteration's ``x``, the
last ``y`` and the last gradient.

Everything runs in ``dtype``: float64 for the reference, bfloat16 for the
control that the benchmark's limits must reject.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


class Group(NamedTuple):
    """Columns whose degree lies in ``(L/2, L]``, padded to ``L`` lanes:
    padding lanes have ``a = c = 0`` and row 0, so their x is 0."""

    rows: torch.Tensor  # (K, L) int32
    a: torch.Tensor  # (K, L)
    c: torch.Tensor  # (K, L)


class CallResult(NamedTuple):
    objectives: List[float]  # the dual objective at each iteration's x
    dual: torch.Tensor  # the last y
    gradient: torch.Tensor  # the gradient at the last x


def fista_betas(n: int) -> List[float]:
    t = [0.0]
    for _ in range(n + 1):
        t.append((1.0 + math.sqrt(1.0 + 4.0 * t[-1] * t[-1])) / 2.0)
    return [(1.0 - t[i + 1]) / t[i + 2] for i in range(n)]


def project_simplex_ineq(z: torch.Tensor, radius: float, tol: float) -> torch.Tensor:
    """Each row of ``z`` projected onto ``{x >= 0, sum x <= radius}``."""
    zp = torch.clamp_min(z, 0)
    feasible = zp.sum(dim=1, keepdim=True) <= radius + tol
    u = torch.sort(zp, dim=1, descending=True).values
    css = torch.cumsum(u, dim=1)
    k = torch.arange(1, z.shape[1] + 1, device=z.device).to(z.dtype)
    rho = torch.sum(u - (css - radius) / k > 0, dim=1, keepdim=True).clamp_min(1)
    theta = (css.gather(1, rho - 1) - radius) / rho.to(z.dtype)
    return torch.where(feasible, zp, torch.clamp_min(zp - theta, 0))


class MatchingReference:
    """The matching LP on ``device`` in ``dtype``, built from host CSC arrays
    (``indptr`` (n+1,), ``rows`` (nnz,), ``a`` and ``c`` (nnz,), ``b`` (m,)).

    Sharded: built from a range of the columns (and the whole ``b``), with
    ``reduce`` summing the flat buffer ``(A x, c.x, x.x)`` of every shard's
    columns, once an evaluation, so each shard follows the whole problem's
    AGD.  Without ``reduce`` the columns given are the whole problem."""

    def __init__(self, indptr, rows, a, c, b, gamma: float, radius: float, tol: float, dtype, device,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.dtype, self.device, self.reduce = dtype, torch.device(device), reduce
        self.gamma, self.radius, self.tol = gamma, radius, tol
        self.m = int(np.asarray(b).shape[0])
        indptr = torch.as_tensor(np.asarray(indptr), dtype=torch.int64, device=self.device)
        rows_t = torch.as_tensor(np.asarray(rows), device=self.device).to(torch.int32)
        a_t = torch.as_tensor(np.asarray(a), device=self.device).to(dtype)
        c_t = torch.as_tensor(np.asarray(c), device=self.device).to(dtype)
        self.b = torch.as_tensor(np.asarray(b), device=self.device).to(dtype)
        deg = indptr[1:] - indptr[:-1]
        width = torch.ones_like(deg)
        while bool((width < deg).any()):
            width = torch.where(width < deg, width * 2, width)
        self.groups: List[Group] = []
        slots, slot_rows, offset = [], [], 0
        for L in torch.unique(width[deg > 0]).tolist():
            cols = torch.nonzero((width == L) & (deg > 0)).flatten()
            lane = torch.arange(L, device=self.device)
            valid = lane[None, :] < deg[cols, None]
            idx = torch.where(valid, indptr[cols, None] + lane[None, :], 0)
            zero = torch.zeros((), dtype=dtype, device=self.device)
            g = Group(rows=torch.where(valid, rows_t[idx], 0), a=torch.where(valid, a_t[idx], zero),
                      c=torch.where(valid, c_t[idx], zero))
            self.groups.append(g)
            slots.append(offset + torch.nonzero(valid.flatten()).flatten())
            slot_rows.append(g.rows[valid].to(torch.int64))
            offset += valid.numel()
            del cols, valid, idx
        # the row sums: every real slot, in row order, summed per row
        slot_rows = torch.cat(slot_rows)
        self.order = torch.cat(slots)[torch.argsort(slot_rows, stable=True)]
        self.row_counts = torch.bincount(slot_rows, minlength=self.m)
        del slots, slot_rows

    def evaluate(self, lam: torch.Tensor):
        """(objective, gradient) at ``lam``."""
        scale = -1.0 / self.gamma
        s = lam * scale
        cx = torch.zeros((), dtype=self.dtype, device=self.device)
        xx = torch.zeros((), dtype=self.dtype, device=self.device)
        ax = []
        for g in self.groups:
            z = g.a * s.index_select(0, g.rows.flatten()).view(g.rows.shape) + scale * g.c
            x = project_simplex_ineq(z, self.radius, self.tol)
            ax.append((g.a * x).flatten())
            cx = cx + torch.sum(g.c * x)
            xx = xx + torch.sum(x * x)
        ax = torch.segment_reduce(torch.cat(ax)[self.order], "sum", lengths=self.row_counts)
        if self.reduce is not None:  # a shard's sums, summed over the shards
            sums = self.reduce(torch.cat([ax, cx.reshape(1), xx.reshape(1)]))
            ax, cx, xx = sums[:self.m], sums[self.m], sums[self.m + 1]
        grad = ax - self.b
        return cx + (self.gamma / 2) * xx + torch.dot(lam, grad), grad

    def agd_call(self, lam0, iterations: int, initial_step: float, max_step: float,
                 history: int = 15) -> CallResult:
        """One AGD call of ``iterations`` iterations from ``lam0`` with a fresh state."""
        y = torch.as_tensor(lam0, device=self.device).to(self.dtype)
        x = y
        grads, duals, objectives, grad = [], [], [], None
        for beta in fista_betas(iterations):
            obj, grad = self.evaluate(x)
            objectives.append(obj)
            grads, duals = (grads + [grad])[-history:], (duals + [y])[-history:]
            step = initial_step
            if len(grads) == history:
                ratios = torch.stack([torch.linalg.vector_norm(grads[i + 1] - grads[i])
                                      / torch.linalg.vector_norm(duals[i + 1] - duals[i])
                                      for i in range(history - 1)])
                l_max = float(torch.max(ratios))
                if math.isfinite(l_max):
                    step = min(1.0 / l_max, max_step) if l_max != 0 else max_step
            y_new = torch.clamp_min(x + step * grad, 0)
            x = y_new + beta * (y - y_new)
            y = y_new
        return CallResult([float(o) for o in objectives], y, grad)
