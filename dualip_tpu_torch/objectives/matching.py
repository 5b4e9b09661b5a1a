"""Matching-LP dual objective, csc layout on one device
(``dualip_tpu/objectives/matching.py``).

Per dual-gradient evaluation, for every BlockCSC tile:

    z = a * (-lambda/gamma)[rows] + (-1/gamma) * c  ->  x = Proj(z)  ->  mask
    grad += segment-sum of a*x by row;  obj += sum(c*x);  reg += (gamma/2) sum(x^2)

then ``calc_grad`` subtracts ``b`` and adds ``reg + lambda . grad`` to the
objective.  ``use_pallas=False`` runs the registry projections as torch ops
on ``(K, L)`` tiles.  ``use_pallas=True`` (the name is the JAX package's)
runs the hand-written fused tile kernel ``ops/fused_matching.py`` on
``(L, K)``-transposed tiles: the gather ``scaled[rows]`` is ``index_select``
and the segment-sum is ``index_add_`` around it, as the JAX package leaves
both to XLA around its Pallas kernel.  On CUDA, ``index_add_`` adds with
atomics, so the gradient's summation order changes from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dualip_tpu_torch.objectives.base import BaseInputArgs, BaseObjective
from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse.bcsc import (
    BlockCSC,
    Tile,
    build_blockcsc,
    device_put_blockcsc,
    tile_valid_mask,
    tiles_values_to_flat,
)
from dualip_tpu_torch.sparse.csc import CSCMatrix
from dualip_tpu_torch.types import ObjectiveResult, resolve_device


@dataclass
class MatchingInputArgs(BaseInputArgs):
    """``A`` and ``c``: same-pattern host CSC matrices (``m`` constraint rows
    x ``n`` entity columns); ``b_vec``: the (m,) budget (``None`` marks a
    shard-local partition)."""

    A: CSCMatrix
    c: CSCMatrix
    projection_map: Dict[str, ProjectionEntry]
    b_vec: Optional[np.ndarray]
    equality_mask: Optional[np.ndarray] = None


def calc_grad(dual_grad, dual_obj, dual_val, b_vec, reg_penalty):
    """grad -= b; obj += reg + lambda . grad."""
    dual_grad = dual_grad - b_vec
    dual_obj = dual_obj + reg_penalty + torch.dot(dual_val, dual_grad)
    return dual_grad, dual_obj


def transpose_tiles(bcsc: BlockCSC) -> BlockCSC:
    """Host tiles re-laid out to (L, K) for the fused kernel: neighbouring
    entity columns sit at neighbouring addresses."""
    tiles_T = [
        Tile(
            rows=np.ascontiguousarray(t.rows.T),
            a=np.ascontiguousarray(t.a.T),
            c=np.ascontiguousarray(t.c.T),
            length=t.length,
            col_ids=t.col_ids,
        )
        for t in bcsc.tiles
    ]
    return BlockCSC(tiles=tiles_T, specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz)


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device``; a host float is filled in place, not copied
    (a copy from the host would wait for the device)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), float(v), dtype=dtype, device=device)


def _neg_inv_gamma(gamma, dtype, device) -> torch.Tensor:
    return _scalar(-1.0, dtype, device) / _scalar(gamma, dtype, device)


def matching_local_parts_pallas(
    bcsc_T: BlockCSC, dual_val: torch.Tensor, gamma, block_k: int, want_primal: bool = False,
    tile_eval=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(grad, dual_obj, reg, [x tiles in (L, K)]) through the fused kernel.

    ``tile_eval`` stands in for ``fused_tile_eval_T`` with its signature (a
    check runs the plain version on the card through it)."""
    from dualip_tpu_torch.ops.fused_matching import fused_tile_eval_T

    tile_eval = tile_eval or fused_tile_eval_T

    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val

    grad = torch.zeros(bcsc_T.m, dtype=dtype, device=dev)
    dual_obj = torch.zeros((), dtype=dtype, device=dev)
    reg_sum = torch.zeros((), dtype=dtype, device=dev)
    xs: List[torch.Tensor] = []
    for tile, spec in zip(bcsc_T.tiles, bcsc_T.specs):
        rows = tile.rows.reshape(-1)
        lam_g = scaled.index_select(0, rows).view(tile.a.shape)
        ax, obj_p, reg_p, *x_p = tile_eval(
            lam_g,
            tile.a,
            tile.c,
            tile.length,
            neg_inv_gamma,
            spec.proj_type,
            spec.proj_params,
            block_k=min(block_k, tile.a.shape[1]),
            want_x=want_primal,
        )
        if want_primal:
            xs.append(x_p[0])
        grad.index_add_(0, rows, ax.reshape(-1))
        dual_obj = dual_obj + obj_p.to(dtype)
        reg_sum = reg_sum + reg_p.to(dtype)
    reg = (_scalar(gamma, dtype, dev) / 2) * reg_sum
    return grad, dual_obj, reg, xs


def matching_local_parts(
    bcsc: BlockCSC, dual_val: torch.Tensor, gamma, want_primal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(grad, dual_obj, reg, [x tiles in (K, L)]) through the registry
    projections on (K, L) tiles."""
    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val
    half_gamma = _scalar(gamma, dtype, dev) / 2

    grad = torch.zeros(bcsc.m, dtype=dtype, device=dev)
    dual_obj = torch.zeros((), dtype=dtype, device=dev)
    reg = torch.zeros((), dtype=dtype, device=dev)
    xs: List[torch.Tensor] = []
    zero = torch.zeros((), dtype=dtype, device=dev)
    for tile, spec in zip(bcsc.tiles, bcsc.specs):
        rows = tile.rows.reshape(-1)
        z = tile.a * scaled.index_select(0, rows).view(tile.a.shape) + neg_inv_gamma * tile.c
        x = spec.projection()(z)
        x = torch.where(tile_valid_mask(tile, spec.L), x, zero)
        grad.index_add_(0, rows, (tile.a * x).reshape(-1))
        reg = reg + half_gamma * torch.sum(x * x)
        dual_obj = dual_obj + torch.sum(tile.c * x)
        if want_primal:
            xs.append(x)
    return grad, dual_obj, reg, xs


def _finalize(grad, dual_obj, reg, dual_val, b_vec) -> ObjectiveResult:
    grad, dual_obj = calc_grad(grad, dual_obj, dual_val, b_vec, reg)
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    return ObjectiveResult(
        dual_gradient=grad,
        dual_objective=dual_obj,
        reg_penalty=reg,
        dual_val_times_grad=torch.dot(dual_val, grad),
        max_pos_slack=torch.maximum(torch.amax(grad), zero),
        sum_pos_slack=torch.sum(torch.clamp_min(grad, 0.0)),
    )


def _later_slice(what: str, slice_name: str):
    raise NotImplementedError(f"{what} belongs to the {slice_name} slice of the port, not yet ported")


class MatchingSolverDualObjectiveFunction(BaseObjective):
    """Single-device matching objective on the csc layout.

    The constructor keeps the JAX package's keywords so one ``objective_kwargs``
    builds either package's objective.  ``use_pallas=True`` here means the
    hand-written fused tile kernel (``ops/fused_matching.py``);
    ``pallas_block_k`` pads each tile's entity count to a multiple of it, as
    in the JAX package.  ``device`` (default ``cuda``) is where the tiles and
    the solve live.  Options of later slices raise ``NotImplementedError``:
    ``mesh`` (distributed), ``layout="row"/"butterfly"``, ``carry_dtype``,
    ``compact``, ``srow_gather`` and ``plan_cache_dir`` (butterfly layout),
    ``tile_cache_dir`` (I/O tiers).
    """

    def __init__(
        self,
        matching_input_args: MatchingInputArgs,
        gamma: float,
        batching: bool = True,
        mesh=None,
        keep_flat_idx: bool = True,
        dtype=np.float32,
        use_pallas: bool = False,
        pallas_block_k: int = 1024,
        layout: str = "csc",
        plan_cache_dir=None,
        keep_col_tiles: bool = True,
        carry_dtype=None,
        tile_cache_dir=None,
        tile_cache_key=None,
        compact: bool = False,
        srow_gather: bool = False,
        device=None,
    ):
        del keep_col_tiles, tile_cache_key  # butterfly/cache keywords with no csc meaning
        if layout not in ("csc", "row", "butterfly"):
            raise ValueError(f"Unknown layout {layout!r} (expected 'csc', 'row' or 'butterfly')")
        if mesh is not None:
            _later_slice("mesh (entity-sharded solve)", "distributed")
        if layout != "csc":
            _later_slice(f"layout={layout!r}", "butterfly-layout")
        for name, val in (("carry_dtype", carry_dtype), ("compact", compact),
                          ("srow_gather", srow_gather), ("plan_cache_dir", plan_cache_dir)):
            if val:
                _later_slice(name, "butterfly-layout")
        if tile_cache_dir is not None:
            _later_slice("tile_cache_dir", "I/O-tiers")

        args = matching_input_args
        self.device = resolve_device(device)
        self.gamma = gamma
        self.is_distributed = args.b_vec is None
        self.use_pallas = use_pallas
        self.pallas_block_k = pallas_block_k
        self.layout = layout
        self.equality_mask = (
            torch.as_tensor(np.asarray(args.equality_mask, dtype=bool), device=self.device)
            if args.equality_mask is not None
            else None
        )
        bcsc = build_blockcsc(
            args.A,
            args.c,
            args.projection_map,
            batching=batching,
            pad_cols_to=pallas_block_k if use_pallas else 1,
            keep_flat_idx=keep_flat_idx,
            dtype=dtype,
        )
        if use_pallas:
            bcsc = transpose_tiles(bcsc)
        self.bcsc = device_put_blockcsc(bcsc, self.device)
        # every input in the objective's dtype (numpy float64 b would
        # otherwise stay float64 in torch)
        self.b_vec = (
            torch.as_tensor(np.asarray(args.b_vec, dtype=dtype), device=self.device)
            if args.b_vec is not None
            else None
        )

    @property
    def params(self):
        return (self.bcsc, self.b_vec)

    def _local(self, bcsc, dual_val, gamma, want_primal=False):
        if self.use_pallas:
            return matching_local_parts_pallas(bcsc, dual_val, gamma, self.pallas_block_k, want_primal)
        return matching_local_parts(bcsc, dual_val, gamma, want_primal)

    def calculate_traceable(self, params, dual_val: torch.Tensor, gamma) -> ObjectiveResult:
        bcsc, b_vec = params
        g = self.gamma if gamma is None else gamma
        grad, dual_obj, reg, _ = self._local(bcsc, dual_val, g)
        if b_vec is not None:
            return _finalize(grad, dual_obj, reg, dual_val, b_vec)
        return ObjectiveResult(dual_gradient=grad, dual_objective=dual_obj, reg_penalty=reg)

    def calculate(
        self,
        dual_val,
        gamma: Optional[float] = None,
        save_primal: bool = False,
        rank: int = 0,
        **kwargs,
    ) -> ObjectiveResult:
        del rank, kwargs
        g = self.gamma if gamma is None else gamma
        dual_val = torch.as_tensor(dual_val, device=self.device)
        if not save_primal:
            return self.calculate_traceable(self.params, dual_val, g)
        if any(spec.flat_idx is None for spec in self.bcsc.specs):
            raise NotImplementedError(
                "save_primal needs the flat CSC index map; build the objective with keep_flat_idx=True"
            )
        grad, dual_obj, reg, xs = self._local(self.bcsc, dual_val, g, want_primal=True)
        primal_obj = dual_obj  # c.x before finalization
        if self.b_vec is not None:
            res = _finalize(grad, dual_obj, reg, dual_val, self.b_vec)
        else:
            res = ObjectiveResult(dual_gradient=grad, dual_objective=dual_obj, reg_penalty=reg)
        res.primal_objective = primal_obj
        # each tile's x in (K, L) form, scattered to flat CSC order on the host
        xs_kl = [(x.T if self.use_pallas else x).cpu().numpy() for x in xs]
        res.primal_var = tiles_values_to_flat(self.bcsc, xs_kl)
        return res
