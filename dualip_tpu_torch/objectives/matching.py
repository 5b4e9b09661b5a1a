"""Matching-LP dual objective on one device
(``dualip_tpu/objectives/matching.py``).

Per dual-gradient evaluation, for every BlockCSC tile:

    z = a * (-lambda/gamma)[rows] + (-1/gamma) * c  ->  x = Proj(z)  ->  mask
    grad += segment-sum of a*x by row;  obj += sum(c*x);  reg += (gamma/2) sum(x^2)

then ``calc_grad`` subtracts ``b`` and adds ``reg + lambda . grad`` to the
objective.  Three layouts compute it:

* ``layout="csc"``: column tiles.  ``use_pallas=False`` runs the registry
  projections as torch ops on ``(K, L)`` tiles; ``use_pallas=True`` (the name
  is the JAX package's) runs the hand-written fused tile kernel
  ``ops/fused_matching.py`` (K1/K2) on ``(L, K)``-transposed tiles.  The gather
  ``scaled[rows]`` is ``index_select``; the row segment-sum is
  ``ops/segment_sum.py``, which adds in a fixed order on every device, so a
  solve repeats itself bit for bit.
* ``layout="butterfly"``: the row-major companion layout
  (``sparse/rowmajor.py``).  The masked dual broadcast ``srow`` is carried from
  row space to column space through a Benes plan (``ops/butterfly.py``, K5-K7),
  the panel kernel (``ops/fused_matching.py::fused_panel_project``, K3/K4)
  projects each tile's region of the carry buffer in place, the same plan
  walked backwards carries ``a*x`` back, and the gradient is a dense row sum.
* ``layout="row"``: the same companion layout connected by per-nnz index
  gathers instead of the plan (no kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dualip_tpu_torch.objectives.base import BaseInputArgs, BaseObjective
from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.ops.segment_sum import segment_sum_rows
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
    return BlockCSC(tiles=tiles_T, specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz, transposed=True)


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device``; a host float is filled in place, not copied
    (a copy from the host would wait for the device)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), float(v), dtype=dtype, device=device)


def _neg_inv_gamma(gamma, dtype, device) -> torch.Tensor:
    return _scalar(-1.0, dtype, device) / _scalar(gamma, dtype, device)


def matching_local_parts_pallas(
    bcsc_T: BlockCSC, dual_val: torch.Tensor, gamma, block_k: int, want_primal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(grad, dual_obj, reg, [x tiles in (L, K)]) through the fused kernel."""
    from dualip_tpu_torch.ops.fused_matching import fused_tile_eval_T

    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val

    grad = torch.zeros(bcsc_T.m, dtype=dtype, device=dev)
    dual_obj = torch.zeros((), dtype=dtype, device=dev)
    reg_sum = torch.zeros((), dtype=dtype, device=dev)
    xs: List[torch.Tensor] = []
    orders = bcsc_T.row_orders or [None] * len(bcsc_T.tiles)
    for tile, spec, row_order in zip(bcsc_T.tiles, bcsc_T.specs, orders):
        rows = tile.rows.reshape(-1)
        lam_g = scaled.index_select(0, rows).view(tile.a.shape)
        ax, obj_p, reg_p, *x_p = fused_tile_eval_T(
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
        segment_sum_rows(grad, ax, tile.rows, row_order)
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
    orders = bcsc.row_orders or [None] * len(bcsc.tiles)
    for tile, spec, row_order in zip(bcsc.tiles, bcsc.specs, orders):
        rows = tile.rows.reshape(-1)
        z = tile.a * scaled.index_select(0, rows).view(tile.a.shape) + neg_inv_gamma * tile.c
        x = spec.projection()(z)
        x = torch.where(tile_valid_mask(tile, spec.L), x, zero)
        segment_sum_rows(grad, tile.a * x, tile.rows, row_order)
        reg = reg + half_gamma * torch.sum(x * x)
        dual_obj = dual_obj + torch.sum(tile.c * x)
        if want_primal:
            xs.append(x)
    return grad, dual_obj, reg, xs


def _srow_parts(rl, values: torch.Tensor, fill: torch.Tensor) -> List[torch.Tensor]:
    """Per row tile, ``values[row_ids]`` broadcast along each row's valid
    lanes and ``fill`` on its padding lanes, flattened."""
    parts = []
    for rt, (R, Lr) in zip(rl.row_tiles, rl.row_shapes):
        lane = torch.arange(Lr, dtype=torch.int32, device=values.device)
        s = torch.where(lane[None, :] < rt.length[:, None], values.index_select(0, rt.row_ids)[:, None], fill)
        parts.append(s.reshape(-1))
    return parts


def _plan_size(plan) -> int:
    return plan.N if hasattr(plan, "N") else plan.masks.shape[1]


def _carry(rl, vec: torch.Tensor, reverse: bool, truncate: bool = True) -> torch.Tensor:
    """One application of the layout's plan: the kernels on a CUDA layout
    (in place on a full-length ``vec``), the plain stages on the CPU."""
    from dualip_tpu_torch.ops.butterfly import apply_butterfly, apply_butterfly_cuda

    if rl.use_cuda_kernel:
        return apply_butterfly_cuda(rl.plan, vec, reverse=reverse, truncate=truncate)
    return apply_butterfly(rl.plan, vec, reverse=reverse, truncate=truncate)


def route_row_ids(rl, m: int) -> torch.Tensor:
    """``RowLayout.srow_colidx``: the forward carry's action on the row-id
    broadcast, (N,) int32 with the sentinel ``m`` on padding.  The ids ride
    float32 through the same carry the hot path uses, so ``m`` must stay below
    2^24."""
    if m >= (1 << 24):
        raise ValueError(
            "srow_gather routes row ids exactly through an fp32 carry; "
            f"m={m} exceeds the 2^24 exact-integer range"
        )
    dev = rl.row_pos.device
    N = _plan_size(rl.plan)
    sent = torch.full((), float(m), dtype=torch.float32, device=dev)
    parts = _srow_parts(rl, torch.arange(m, dtype=torch.float32, device=dev), sent)
    used = sum(p.numel() for p in parts)
    vec = torch.cat(parts + [sent.expand(N - used)])
    return _carry(rl, vec, reverse=False, truncate=False).to(torch.int32)


def matching_local_parts_rowmajor(
    bcsc: BlockCSC,
    rl,
    dual_val: torch.Tensor,
    gamma,
    block_k: int = 1024,
    carry_dtype=None,
    want_primal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(grad, dual_obj, reg, [x tiles]) through the row-major companion layout.

    The same arithmetic as ``matching_local_parts``; the gradient is summed per
    row along dense lanes instead of by a segment-sum, so it agrees within
    float32 reassociation.  With a plan (butterfly mode) the carries run
    through it forward and backward and the panel kernel projects the carry
    buffer in place; without one (gather mode) they are index gathers.

    ``carry_dtype`` (butterfly only, e.g. ``torch.bfloat16``) is the storage
    type of the carry buffer: the network does no arithmetic, so the only cost
    is one rounding of srow before the forward carry and one of ``a*x`` after
    the projection; the row sums accumulate in the dual's dtype."""
    del block_k
    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val  # (m,)
    zero = torch.zeros((), dtype=dtype, device=dev)
    half_gamma = _scalar(gamma, dtype, dev) / 2
    butterfly = rl.plan is not None

    dual_obj = torch.zeros((), dtype=dtype, device=dev)
    reg = torch.zeros((), dtype=dtype, device=dev)
    xs: List[torch.Tensor] = []  # want_primal: per-tile x (panel form in butterfly mode)

    if butterfly:
        from dualip_tpu_torch.ops.fused_matching import fused_panel_project

        N = _plan_size(rl.plan)
        if rl.srow_colidx is not None:
            # the forward carry's action on the row-id broadcast was computed
            # at setup, so the (m+1)-entry scaled table (sentinel slot = 0) is
            # gathered straight into column space: the same bits as routing
            table = torch.cat([scaled, zero.reshape(1)])
            if carry_dtype is not None:
                table = table.to(carry_dtype)
            buf = table.index_select(0, rl.srow_colidx)
        else:
            # srow carry: ship the masked dual broadcast, zero on padding
            # slots, in a buffer of the plan's full length so the kernels
            # work in place
            parts = _srow_parts(rl, scaled, zero)
            used = sum(p.numel() for p in parts)
            z_cat = torch.cat(parts + [torch.zeros(N - used, dtype=dtype, device=dev)])
            if carry_dtype is not None:
                z_cat = z_cat.to(carry_dtype)
            buf = _carry(rl, z_cat, reverse=False, truncate=False)  # full (N,)
        packs = rl.col_pack if rl.col_pack is not None else (None,) * len(rl.col_tiles_T)
        for pt, spec, off, pk in zip(rl.col_tiles_T, bcsc.specs, rl.col_offsets, packs):
            buf, obj_p, reg_p, *x_p = fused_panel_project(
                buf, pt.a, pt.c, pt.length, off, spec.proj_type, spec.proj_params,
                want_x=want_primal, neg_inv_gamma=neg_inv_gamma, pack=pk,
            )
            if want_primal:
                xs.append(x_p[0])
            dual_obj = dual_obj + obj_p.to(dtype)
            reg = reg + half_gamma * reg_p.to(dtype)
        # carry 2: a*x (in place in buf) back into row tiles; dense row sums
        ax_row_cat = _carry(rl, buf, reverse=True)
        sums = []
        off = 0
        for R, Lr in rl.row_shapes:
            blk = ax_row_cat[off : off + R * Lr].view(R, Lr)
            off += R * Lr
            sums.append(torch.sum(blk, dim=1, dtype=dtype))
    else:
        # z in row layout: the dual value is constant along a row
        z_parts = [
            (rt.a * scaled.index_select(0, rt.row_ids)[:, None] + neg_inv_gamma * rt.c).reshape(-1)
            for rt in rl.row_tiles
        ]
        z_cat = torch.cat(z_parts + [zero.reshape(1)])
        ax_parts = []
        for i, (tile, spec) in enumerate(zip(bcsc.tiles, bcsc.specs)):
            z = z_cat.index_select(0, rl.zidx[i].reshape(-1)).view(rl.zidx[i].shape)
            x = spec.projection()(z)
            x = torch.where(tile_valid_mask(tile, spec.L), x, zero)
            ax_parts.append((tile.a * x).reshape(-1))
            reg = reg + half_gamma * torch.sum(x * x)
            dual_obj = dual_obj + torch.sum(tile.c * x)
            if want_primal:
                xs.append(x)
        ax_cat = torch.cat(ax_parts + [zero.reshape(1)])
        sums = [
            torch.sum(ax_cat.index_select(0, rt.axidx.reshape(-1)).view(rt.axidx.shape), dim=1)
            for rt in rl.row_tiles
        ]
    sums_cat = torch.cat(sums + [zero.reshape(1)])
    grad = sums_cat.index_select(0, rl.row_pos)
    return grad, dual_obj, reg, xs


def _panel_x_to_kl(x_np: np.ndarray, K: int, pk) -> np.ndarray:
    """Re-layout a want_x panel output to the (K, L) column-tile form.  Plain
    panels arrive as (K//128, L, 128); compact panels as (BP, q*L, 128) with
    shortfall padding rows, unstacked to the real (K//128, L, 128) panels."""
    if pk is None:
        return x_np.transpose(0, 2, 1).reshape(-1, x_np.shape[1])
    L, _L2, _q = pk
    return x_np.reshape(-1, L, 128)[: K // 128].transpose(0, 2, 1).reshape(K, L)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name or anything numpy names."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "__name__", None) or np.dtype(dtype).name
    out = getattr(torch, str(name), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype the carry buffer can take: {dtype!r}")
    return out


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
    """Single-device matching objective.

    The constructor keeps the JAX package's keywords so one ``objective_kwargs``
    builds either package's objective.  ``layout`` selects the gradient
    formulation: ``"csc"`` (column tiles and a row segment-sum; with
    ``use_pallas=True`` the hand-written fused tile kernel, for which
    ``pallas_block_k`` pads each tile's entity count), ``"butterfly"`` (the
    row-major companion layout carried through a Benes plan, with the panel
    kernel) or ``"row"`` (the companion layout through index gathers).

    Butterfly-only keywords: ``compact`` (q columns per power-of-two buffer
    row, exact column buckets, geometric row buckets), ``carry_dtype`` (storage
    type of the carry buffer, e.g. ``"bfloat16"``), ``srow_gather`` (the
    forward carry replaced by one table gather), ``plan_cache_dir`` (the routed
    plan cached on disk), ``keep_col_tiles=False`` (drop the (K, L) tiles the
    hot path never reads).  ``device`` (default ``cuda``) is where the tiles
    and the solve live.  ``mesh`` (distributed) and ``tile_cache_dir`` (I/O
    tiers) belong to later slices and raise ``NotImplementedError``.
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
        del tile_cache_key
        if layout not in ("csc", "row", "butterfly"):
            raise ValueError(f"Unknown layout {layout!r} (expected 'csc', 'row' or 'butterfly')")
        if layout == "row" and (mesh is not None or use_pallas):
            raise ValueError("layout='row' is single-device and exclusive with use_pallas")
        if layout == "butterfly" and use_pallas:
            raise ValueError(
                "layout='butterfly' runs its own fused kernel; use_pallas is the csc-layout flag"
            )
        if carry_dtype is not None:
            if layout != "butterfly":
                raise ValueError("carry_dtype is a butterfly-layout knob")
            carry_dtype = _torch_dtype(carry_dtype)
        if compact and layout != "butterfly":
            raise ValueError("compact packing is butterfly-only")
        if srow_gather:
            if layout != "butterfly":
                raise ValueError("srow_gather is a butterfly-layout knob")
            if mesh is not None:
                raise ValueError(
                    "srow_gather is single-device only (the stacked sharded "
                    "layout carries per-shard plans; route srow there)"
                )
        if mesh is not None:
            _later_slice("mesh (entity-sharded solve)", "distributed")
        if tile_cache_dir is not None:
            _later_slice("tile_cache_dir", "I/O-tiers")

        args = matching_input_args
        self.device = resolve_device(device)
        self.gamma = gamma
        self.is_distributed = args.b_vec is None
        self.use_pallas = use_pallas
        self.pallas_block_k = pallas_block_k
        self.layout = layout
        self.carry_dtype = carry_dtype
        self.compact = compact
        self.srow_gather = srow_gather
        self.equality_mask = (
            torch.as_tensor(np.asarray(args.equality_mask, dtype=bool), device=self.device)
            if args.equality_mask is not None
            else None
        )
        pad = pallas_block_k if use_pallas else 1
        if layout == "butterfly":
            # the panel kernel reads the carry buffer in 128-column panels
            pad = max(pad, max(pallas_block_k, 128))
        bcsc = build_blockcsc(
            args.A,
            args.c,
            args.projection_map,
            batching=batching,
            pad_cols_to=pad,
            keep_flat_idx=keep_flat_idx,
            dtype=dtype,
            # compact: one bucket per distinct degree, no within-tile slot padding
            bucketing="exact" if compact else "pow2",
        )
        self.row_layout = None
        if layout in ("row", "butterfly"):
            from dualip_tpu_torch.sparse.rowmajor import build_row_layout

            self.row_layout = build_row_layout(  # host tiles
                bcsc,
                method="butterfly" if layout == "butterfly" else "gather",
                plan_cache_dir=plan_cache_dir,
                compact=compact,
                device=self.device,
            )
        if layout == "butterfly" and not keep_col_tiles:
            # the butterfly hot path never reads the (K, L) column tiles (the
            # layout carries panel copies)
            self.bcsc = BlockCSC(tiles=[], specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz)
        else:
            if use_pallas:
                bcsc = transpose_tiles(bcsc)
            # the row-sorted orders serve the csc layout's segment-sum only
            self.bcsc = device_put_blockcsc(bcsc, self.device, row_orders=layout == "csc")
        if srow_gather:
            self.row_layout.srow_colidx = route_row_ids(self.row_layout, self.bcsc.m)
        # every input in the objective's dtype (numpy float64 b would
        # otherwise stay float64 in torch)
        self.b_vec = (
            torch.as_tensor(np.asarray(args.b_vec, dtype=dtype), device=self.device)
            if args.b_vec is not None
            else None
        )

    @property
    def params(self):
        return (self.bcsc, self.b_vec, self.row_layout)

    def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
        if row_layout is not None:
            return matching_local_parts_rowmajor(
                bcsc, row_layout, dual_val, gamma, block_k=self.pallas_block_k,
                carry_dtype=self.carry_dtype, want_primal=want_primal,
            )
        if self.use_pallas:
            return matching_local_parts_pallas(bcsc, dual_val, gamma, self.pallas_block_k, want_primal)
        return matching_local_parts(bcsc, dual_val, gamma, want_primal)

    def calculate_traceable(self, params, dual_val: torch.Tensor, gamma) -> ObjectiveResult:
        bcsc, b_vec, row_layout = params
        g = self.gamma if gamma is None else gamma
        grad, dual_obj, reg, _ = self._local(bcsc, dual_val, g, row_layout=row_layout)
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
        grad, dual_obj, reg, xs = self._local(
            self.bcsc, dual_val, g, want_primal=True, row_layout=self.row_layout
        )
        primal_obj = dual_obj  # c.x before finalization
        if self.b_vec is not None:
            res = _finalize(grad, dual_obj, reg, dual_val, self.b_vec)
        else:
            res = ObjectiveResult(dual_gradient=grad, dual_objective=dual_obj, reg_penalty=reg)
        res.primal_objective = primal_obj
        # each tile's x in (K, L) form, scattered to flat CSC order on the host
        packs = (
            self.row_layout.col_pack
            if (self.layout == "butterfly" and self.compact)
            else (None,) * len(self.bcsc.specs)
        )
        xs_kl = []
        for x, spec, pk in zip(xs, self.bcsc.specs, packs):
            x = x.cpu().numpy()
            if self.layout == "butterfly":
                x = _panel_x_to_kl(x, spec.K, pk)
            elif self.use_pallas:
                x = x.T  # (L, K) transposed-tile form
            xs_kl.append(x)
        res.primal_var = tiles_values_to_flat(self.bcsc, xs_kl)
        return res
