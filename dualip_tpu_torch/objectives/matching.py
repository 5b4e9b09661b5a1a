"""Matching-LP dual objective on one device
(``dualip_tpu/objectives/matching.py``).

Per dual-gradient evaluation, for every BlockCSC tile:

    z = a * (-lambda/gamma)[rows] + (-1/gamma) * c  ->  x = Proj(z)  ->  mask
    grad += segment-sum of a*x by row;  obj += sum(c*x);  reg += (gamma/2) sum(x^2)

then ``calc_grad`` subtracts ``b`` and adds ``reg + lambda . grad`` to the
objective.  Three layouts compute it:

* ``layout="csc"``: column tiles.  ``use_pallas=False`` runs the registry
  projections on ``(K, L)`` tiles (the simplex on CUDA through the
  sort-and-scan kernel of ``ops/simplex_project.py``, the z formation and
  the sums as torch ops); ``use_pallas=True`` (the name
  is the JAX package's) runs the hand-written fused tile kernel
  ``ops/fused_matching.py`` (K1/K2) on ``(L, K)``-transposed tiles, in its
  gather form (``scaled[rows]`` inside the kernel; the registry path gathers
  with ``index_select``).  Both write every tile's a*x into one flat buffer,
  and one call of ``ops/segment_sum.py`` sums it by row in a fixed order on
  every device, so a solve repeats itself bit for bit.
* ``layout="butterfly"``: the row-major companion layout
  (``sparse/rowmajor.py``).  The masked dual broadcast ``srow`` is carried from
  row space to column space through a Benes plan (``ops/butterfly.py``, K5-K7),
  the panel kernel (``ops/fused_matching.py::fused_panel_project_tiles``,
  K3/K4) projects every tile's region of the carry buffer in place in one
  launch, the same plan walked backwards carries ``a*x`` back, and the
  gradient is a dense row sum.
* ``layout="row"``: the same companion layout connected by per-nnz index
  gathers instead of the plan (no kernel).

With ``mesh`` (``parallel/mesh.py::EntityMesh``, one process per rank) each
rank holds the entity shard the JAX package places on its device d: the
columns ``[d*K/D, (d+1)*K/D)`` of every tile (csc), or its own butterfly
layout built under shapes common to all shards (``build_row_layout_sharded``),
and runs the single-device pipeline on it; one ``all_reduce`` of the flat
buffer ``(grad, obj, reg)`` per evaluation sums the ranks' parts, and
``calc_grad`` and the AGD step then run on every rank on the same bits.
"""

from __future__ import annotations

import dataclasses
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
    TileSpec,
    build_blockcsc,
    build_row_sum_plan,
    device_put_blockcsc,
    is_bfloat16,
    put_row_sum_plan,
    round_bfloat16,
    tile_valid_mask,
    tiles_values_to_flat,
)
from dualip_tpu_torch.sparse.csc import CSCMatrix
from dualip_tpu_torch.types import ObjectiveResult, resolve_device
from dualip_tpu_torch.utils import profiling


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


@profiling.timed("dualip.build.tiles")
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
    return BlockCSC(tiles=tiles_T, specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz, transposed=True,
                    value_dtype=bcsc.value_dtype)


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
    """(grad, dual_obj, reg, [x tiles in (L, K)]) through the fused kernel in
    its gather form, each tile's a*x written into one flat buffer that the
    segment-sum reads whole."""
    from dualip_tpu_torch.ops.fused_matching import fused_tile_gather_eval_T

    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val
    plan = bcsc_T.row_sum

    ax_all = torch.empty(plan.slots, dtype=dtype, device=dev)
    dual_obj = torch.zeros((), dtype=dtype, device=dev)
    reg_sum = torch.zeros((), dtype=dtype, device=dev)
    xs: List[torch.Tensor] = []
    for tile, spec, off in zip(bcsc_T.tiles, bcsc_T.specs, plan.offsets):
        _, obj_p, reg_p, *x_p = fused_tile_gather_eval_T(
            scaled,
            tile.rows,
            tile.a,
            tile.c,
            tile.length,
            neg_inv_gamma,
            spec.proj_type,
            spec.proj_params,
            block_k=min(block_k, tile.a.shape[1]),
            want_x=want_primal,
            out=ax_all[off : off + tile.a.numel()].view(tile.a.shape),
        )
        if want_primal:
            xs.append(x_p[0])
        dual_obj = dual_obj + obj_p.to(dtype)
        reg_sum = reg_sum + reg_p.to(dtype)
    profiling.mark("columns")
    grad = segment_sum_rows(torch.zeros(bcsc_T.m, dtype=dtype, device=dev), ax_all, plan)
    profiling.mark("rows")
    reg = (_scalar(gamma, dtype, dev) / 2) * reg_sum
    return grad, dual_obj, reg, xs


def matching_local_parts(
    bcsc: BlockCSC, dual_val: torch.Tensor, gamma, want_primal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(grad, dual_obj, reg, [x tiles in (K, L)]) through the registry
    projections on (K, L) tiles.  Bfloat16 tiles compute in the dual's dtype,
    as the JAX package's type promotion has it (torch would keep
    ``(-1/gamma) * c`` in bfloat16: a 0-d tensor does not promote)."""
    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val
    half_gamma = _scalar(gamma, dtype, dev) / 2

    dual_obj = torch.zeros((), dtype=dtype, device=dev)
    reg = torch.zeros((), dtype=dtype, device=dev)
    xs: List[torch.Tensor] = []
    ax_parts: List[torch.Tensor] = []
    zero = torch.zeros((), dtype=dtype, device=dev)
    for tile, spec in zip(bcsc.tiles, bcsc.specs):
        rows = tile.rows.reshape(-1)
        a, c = tile.a.to(dtype), tile.c.to(dtype)
        z = a * scaled.index_select(0, rows).view(a.shape) + neg_inv_gamma * c
        x = spec.projection()(z)
        x = torch.where(tile_valid_mask(tile, spec.L), x, zero)
        ax_parts.append((a * x).reshape(-1))
        reg = reg + half_gamma * torch.sum(x * x)
        dual_obj = dual_obj + torch.sum(c * x)
        if want_primal:
            xs.append(x)
    profiling.mark("columns")
    grad = segment_sum_rows(torch.zeros(bcsc.m, dtype=dtype, device=dev), torch.cat(ax_parts), bcsc.row_sum)
    profiling.mark("rows")
    return grad, dual_obj, reg, xs


def matching_exact_cert_csc(
    bcsc: BlockCSC, dual_val: torch.Tensor, gamma
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pieces of the exact matching certificate on column tiles:
    ``(term, cxrow, ax)`` with ``term = sum_i radius_i * max(0, max_k z_ik)``
    (the unregularized dual bound is ``-lambda.b - gamma*term``),
    ``cxrow[r]`` the sum of ``c*x`` over row r's nonzeros and ``ax = A x`` at
    the gamma-subproblem's primal x.  Padding slots enter z as zeros, which
    the ``max(0, .)`` absorbs (a simplex always admits x = 0).

    Tiles may be (K, L) or, for the fused kernel, (L, K) (``transposed``);
    the lanes' axis follows.  The row sums are the fixed-order segment-sum
    of the tiles' ``RowSumPlan``, as in the solve."""
    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val
    lanes = 0 if bcsc.transposed else 1
    term = torch.zeros((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    ax_parts, cx_parts = [], []
    for tile, spec in zip(bcsc.tiles, bcsc.specs):
        a, c = tile.a.to(dtype), tile.c.to(dtype)
        z = a * scaled.index_select(0, tile.rows.reshape(-1)).view(a.shape) + neg_inv_gamma * c
        radius = float(dict(spec.proj_params).get("z", 1.0))
        term = term + radius * torch.sum(torch.clamp_min(torch.amax(z, dim=lanes), 0.0))
        x = spec.projection()(z.movedim(lanes, -1)).movedim(-1, lanes)
        mask = tile_valid_mask(tile, spec.L)
        x = torch.where(mask.T if bcsc.transposed else mask, x, zero)
        ax_parts.append((a * x).reshape(-1))
        cx_parts.append((c * x).reshape(-1))
    sums = [segment_sum_rows(torch.zeros(bcsc.m, dtype=dtype, device=dev), torch.cat(p), bcsc.row_sum)
            for p in (cx_parts, ax_parts)]
    return term, sums[0], sums[1]


def matching_exact_cert_rowmajor(
    bcsc: BlockCSC, rl, dual_val: torch.Tensor, gamma
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The certificate's pieces (as ``matching_exact_cert_csc``) through the
    butterfly layout, plain or compact: one forward carry of srow, the
    projection by the panel kernel's plain version (the certificate is a rare
    check, not the hot loop), and two reverse carries (``a*x`` for ``ax``,
    ``c*x`` for ``cxrow``).  The carries run in the dual's dtype whatever the
    solve's ``carry_dtype``."""
    if rl.plan is None:
        raise ValueError("exact certificate on the row layout needs the butterfly plan")
    from dualip_tpu_torch.ops.fused_matching import _project_block_reference

    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val
    zero = torch.zeros((), dtype=dtype, device=dev)
    N = _plan_size(rl.plan)
    buf = _srow_carried(rl, scaled, zero)

    term = torch.zeros((), dtype=dtype, device=dev)
    u = torch.zeros(N, dtype=dtype, device=dev)  # a*x in panel layout, ghost lanes zero
    w = torch.zeros(N, dtype=dtype, device=dev)  # c*x
    packs = rl.col_pack if rl.col_pack is not None else (None,) * len(rl.col_tiles_T)
    for pt, spec, off, pk in zip(rl.col_tiles_T, bcsc.specs, rl.col_offsets, packs):
        kind, params = spec.proj_type, dict(spec.proj_params)
        radius = float(params.get("z", 1.0))
        a_p, c_p = pt.a.to(dtype), pt.c.to(dtype)
        BP, QL, C = a_p.shape
        L, L2, q = pk if pk is not None else (QL, (1 << max(QL - 1, 0).bit_length()) if QL > 1 else 1, 1)
        region = slice(off, off + BP * L2 * C)
        z = a_p * buf[region].view(BP, L2, C)[:, :QL, :] + neg_inv_gamma * c_p
        z4 = z.view(BP, q, L, C)
        term = term + radius * torch.sum(torch.clamp_min(torch.amax(z4, dim=2), 0.0))
        x = _project_block_reference(z4, kind, params, pt.length[:, :, None, :], L, axis=2).reshape(BP, QL, C)
        u[region].view(BP, L2, C)[:, :QL, :] = a_p * x
        w[region].view(BP, L2, C)[:, :QL, :] = c_p * x

    def back_to_rows(vec):
        vec_row = _carry(rl, vec, reverse=True)
        sums, offr = [], 0
        for R, Lr in rl.row_shapes:
            sums.append(torch.sum(vec_row[offr : offr + R * Lr].view(R, Lr), dim=1, dtype=dtype))
            offr += R * Lr
        return torch.cat(sums + [zero.reshape(1)]).index_select(0, rl.row_pos)

    return term, back_to_rows(w), back_to_rows(u)


def _srow_carried(rl, values: torch.Tensor, fill: torch.Tensor, dtype=None) -> torch.Tensor:
    """The forward carry of ``values[row_ids]`` broadcast along each row
    tile's valid lanes, ``fill`` on the padding lanes and after the row
    space, in ``dtype`` (default: ``values``'), over the plan's full (N,)
    buffer (the kernels work in place)."""
    parts = []
    for rt, (R, Lr) in zip(rl.row_tiles, rl.row_shapes):
        lane = torch.arange(Lr, dtype=torch.int32, device=values.device)
        s = torch.where(lane[None, :] < rt.length[:, None], values.index_select(0, rt.row_ids)[:, None], fill)
        parts.append(s.reshape(-1))
    used = sum(p.numel() for p in parts)
    vec = torch.cat(parts + [fill.expand(_plan_size(rl.plan) - used)])
    if dtype is not None:
        vec = vec.to(dtype)
    return _carry(rl, vec, reverse=False, truncate=False)


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
    sent = torch.full((), float(m), dtype=torch.float32, device=dev)
    return _srow_carried(rl, torch.arange(m, dtype=torch.float32, device=dev), sent).to(torch.int32)


def layout_panel_table(rl, specs):
    """The panel kernel's table (``ops/fused_matching.py::PanelTable``) of a
    butterfly layout's column tiles, each with its projection from ``specs``
    (the BlockCSC's, one per tile)."""
    from dualip_tpu_torch.ops.fused_matching import build_panel_table

    if rl.col_tiles_T is None:
        raise ValueError("the layout has no panel tiles (butterfly mode builds them)")
    packs = rl.col_pack if rl.col_pack is not None else (None,) * len(rl.col_tiles_T)
    kinds = [(s.proj_type, s.proj_params) for s in specs]
    return build_panel_table(rl.col_tiles_T, rl.col_offsets, packs, kinds)


def matching_local_parts_rowmajor(
    bcsc: BlockCSC,
    rl,
    dual_val: torch.Tensor,
    gamma,
    block_k: int = 1024,
    carry_dtype=None,
    want_primal: bool = False,
    panel_table=None,
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
    the projection; the row sums accumulate in the dual's dtype.

    ``panel_table`` (butterfly only) is ``layout_panel_table(rl,
    bcsc.specs)``; a caller that evaluates more than once builds it once and
    passes it (the objective does), else it is built for this call."""
    del block_k
    dtype, dev = dual_val.dtype, dual_val.device
    neg_inv_gamma = _neg_inv_gamma(gamma, dtype, dev)
    scaled = neg_inv_gamma * dual_val  # (m,)
    zero = torch.zeros((), dtype=dtype, device=dev)
    half_gamma = _scalar(gamma, dtype, dev) / 2
    butterfly = rl.plan is not None

    xs: List[torch.Tensor] = []  # want_primal: per-tile x (panel form in butterfly mode)

    if butterfly:
        from dualip_tpu_torch.ops.fused_matching import fused_panel_project_tiles

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
            buf = _srow_carried(rl, scaled, zero, carry_dtype)  # full (N,)
        if panel_table is None:
            panel_table = layout_panel_table(rl, bcsc.specs)
        # every tile in one launch of the panel kernel, in place on buf
        buf, obj_p, reg_p, *x_p = fused_panel_project_tiles(buf, panel_table, neg_inv_gamma, want_x=want_primal)
        profiling.mark("columns")
        if want_primal:
            xs = list(x_p[0])
        dual_obj = obj_p.to(dtype)
        reg = half_gamma * reg_p.to(dtype)
        # carry 2: a*x (in place in buf) back into row tiles; dense row sums
        ax_row_cat = _carry(rl, buf, reverse=True)
        sums = []
        off = 0
        for R, Lr in rl.row_shapes:
            blk = ax_row_cat[off : off + R * Lr].view(R, Lr)
            off += R * Lr
            sums.append(torch.sum(blk, dim=1, dtype=dtype))
    else:
        dual_obj = torch.zeros((), dtype=dtype, device=dev)
        reg = torch.zeros((), dtype=dtype, device=dev)
        # z in row layout: the dual value is constant along a row
        z_parts = [
            (rt.a.to(dtype) * scaled.index_select(0, rt.row_ids)[:, None] + neg_inv_gamma * rt.c.to(dtype)).reshape(-1)
            for rt in rl.row_tiles
        ]
        z_cat = torch.cat(z_parts + [zero.reshape(1)])
        ax_parts = []
        for i, (tile, spec) in enumerate(zip(bcsc.tiles, bcsc.specs)):
            z = z_cat.index_select(0, rl.zidx[i].reshape(-1)).view(rl.zidx[i].shape)
            x = spec.projection()(z)
            x = torch.where(tile_valid_mask(tile, spec.L), x, zero)
            ax_parts.append((tile.a.to(dtype) * x).reshape(-1))
            reg = reg + half_gamma * torch.sum(x * x)
            dual_obj = dual_obj + torch.sum(tile.c.to(dtype) * x)
            if want_primal:
                xs.append(x)
        profiling.mark("columns")
        ax_cat = torch.cat(ax_parts + [zero.reshape(1)])
        sums = [
            torch.sum(ax_cat.index_select(0, rt.axidx.reshape(-1)).view(rt.axidx.shape), dim=1)
            for rt in rl.row_tiles
        ]
    sums_cat = torch.cat(sums + [zero.reshape(1)])
    grad = sums_cat.index_select(0, rl.row_pos)
    profiling.mark("rows")
    return grad, dual_obj, reg, xs


def _panel_x_to_kl(x_np: np.ndarray, K: int, pk, n_shards: int = 1) -> np.ndarray:
    """Re-layout a want_x panel output to the (K, L) column-tile form.  Plain
    panels arrive as (K//128, L, 128) (the shards' panels, concatenated, are
    the global panel order); compact panels as (BP, q*L, 128) per shard with
    each shard's shortfall padding rows, so each shard's block is unstacked
    to its real panels first."""
    if pk is None:
        return x_np.transpose(0, 2, 1).reshape(-1, x_np.shape[1])
    L, _L2, _q = pk
    prd = K // n_shards // 128
    BPd = x_np.shape[0] // n_shards
    parts = [x_np[s * BPd : (s + 1) * BPd].reshape(-1, L, 128)[:prd] for s in range(n_shards)]
    return np.concatenate(parts).transpose(0, 2, 1).reshape(K, L)


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


def _layout_extra(compact: bool, batching: bool, n_shards: int) -> str:
    """The tile-cache key's part for every option that changes the layout, as
    the JAX package spells it: batching moves bucket boundaries, compact
    packs columns (``/g2``: its buffer rows padded to 8), the shard count
    changes every shape."""
    extra = f"compact={compact}/batching={batching}"
    if compact:
        extra += "/g2"
    if n_shards > 1:
        extra += f"/shards={n_shards}"
    return extra


def matching_tile_cache_key(
    matching_input_args,
    n_shards: int = 1,
    pallas_block_k: int = 1024,
    dtype=np.float32,
    compact: bool = False,
    batching: bool = True,
    tile_cache_key=None,
) -> str:
    """The tile-cache key the butterfly objective computes with these options,
    for a process that publishes an entry a later solve looks up."""
    from dualip_tpu_torch.io import tile_cache

    args = matching_input_args
    pad = max(1, n_shards) * max(pallas_block_k, 128)
    return tile_cache.compute_cache_key(args.A, args.c, args.projection_map, pad, dtype, tile_cache_key,
                                        extra=_layout_extra(compact, batching, max(1, n_shards)))


def _mesh_device(mesh, device) -> torch.device:
    """The device of a mesh objective: the mesh's; a ``device`` given beside
    it must name the same one."""
    from dualip_tpu_torch.parallel.mesh import EntityMesh

    if not isinstance(mesh, EntityMesh):
        raise TypeError(f"mesh must be a dualip_tpu_torch.parallel.EntityMesh (default_mesh(...)), got {mesh!r}")
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or (d.index is not None and d != mesh.device):
            raise ValueError(f"device={d} differs from the mesh's device {mesh.device}")
    return mesh.device


def _gathered_flat_idx(mesh, spec: TileSpec) -> TileSpec:
    """``spec`` with the whole tile's ``flat_idx``: every rank's slab (its
    columns ``[d*K/D, (d+1)*K/D)``) stacked in rank order."""
    parts = mesh.all_gather(torch.as_tensor(spec.flat_idx, device=mesh.device))
    return dataclasses.replace(spec, flat_idx=np.concatenate([p.cpu().numpy() for p in parts]))


def reduce_parts(mesh, grad, dual_obj, reg):
    """The ranks' (grad, obj, reg) summed by one ``all_reduce`` of one flat
    buffer of m + 2 values; every rank gets the same bits."""
    buf = mesh.all_reduce_(torch.cat([grad, dual_obj.reshape(1).to(grad.dtype), reg.reshape(1).to(grad.dtype)]))
    m = grad.shape[0]
    return buf[:m], buf[m], buf[m + 1]


class MatchingSolverDualObjectiveFunction(BaseObjective):
    """Matching objective on one device, or sharded over a mesh.

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
    and the solve live.

    ``mesh`` (an ``EntityMesh``; every rank passes the same whole problem):
    the rank keeps its entity shard on ``mesh.device`` (module docstring) and
    each evaluation sums the ranks' parts with one ``all_reduce``; csc (plain
    or ``use_pallas``) and butterfly (plain or ``compact``) layouts.  K is
    padded to ``n_ranks`` (csc), ``n_ranks * pallas_block_k``
    (``use_pallas``) or ``n_ranks * max(pallas_block_k, 128)`` (butterfly),
    as the JAX package pads it.  A csc rank fills only its own columns of
    every tile (``build_blockcsc(..., shard=(rank, n_ranks))``), and only
    those are transposed for ``use_pallas``; a butterfly rank builds the whole
    problem's tiles, which its layout's shape pass reads.  ``save_primal``
    gathers the ranks' x (and on csc their ``flat_idx``), so every rank
    returns the whole primal.  An evaluation on a mesh records the device
    mark ``reduced`` after its ``all_reduce``.

    ``tile_cache_dir`` (butterfly with ``keep_col_tiles=False`` and
    ``keep_flat_idx=False``; other layouts ignore it): the device-ready layout
    cached on disk (``io/tile_cache.py``) under ``self.tile_cache_key``, a hash
    of the problem and the layout's options, or of ``tile_cache_key`` (the
    caller's own name for the problem) and the options.  A hit skips the tile
    fill and the row layout's build; a miss builds them and saves the entry
    when the layout has a plan-cache file (``plan_cache_dir``), on any device.

    The construction is the span ``dualip.build`` of ``utils/profiling.py``,
    recorded always; inside it ``dualip.build.tiles`` (the host tiles, and
    their transpose for ``use_pallas``), ``dualip.build.rows`` (the
    segment-sum's ``RowSumPlan``, or the row layout with its Benes routing
    ``dualip.build.route`` and source index ``dualip.build.index``),
    ``dualip.build.upload`` (the tiles' copies to the device) and the tile
    cache's ``dualip.tile_cache.load`` / ``.save``.
    """

    @profiling.timed("dualip.build")
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
        if use_pallas and is_bfloat16(dtype):
            raise TypeError(
                "use_pallas=True takes float32 tiles: the fused tile kernel (K1/K2) has no bfloat16 form, as the "
                "JAX package's Pallas kernel has none; bfloat16 tiles run on layout='csc' with use_pallas=False "
                "or on layout='butterfly'")
        args = matching_input_args
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else _mesh_device(mesh, device)
        n_shards = mesh.world_size if mesh is not None else 1
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
        pad = n_shards  # K divides over the ranks
        if use_pallas:
            pad *= pallas_block_k
        if layout == "butterfly":
            # the panel kernel reads the carry buffer in 128-column panels
            pad = max(pad, n_shards * max(pallas_block_k, 128))

        cached = self.tile_cache_key = None
        use_cache = tile_cache_dir is not None and layout == "butterfly" and not keep_col_tiles and not keep_flat_idx
        if use_cache:
            from dualip_tpu_torch.io import tile_cache

            self.tile_cache_key = tile_cache.compute_cache_key(
                args.A, args.c, args.projection_map, pad, dtype, tile_cache_key,
                extra=_layout_extra(compact, batching, n_shards))
            cached = tile_cache.load_butterfly_state(
                tile_cache_dir, self.tile_cache_key, self.device,
                shard=(mesh.rank, n_shards) if mesh is not None else None)

        # a csc rank fills only its own columns of every tile; the butterfly's shape pass needs them all
        shard = (mesh.rank, n_shards) if mesh is not None and layout == "csc" else None
        if cached is not None:
            bcsc, self.row_layout = cached
        else:
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
                shard=shard,
            )
            self.row_layout = None
            if layout == "butterfly" and mesh is not None:
                from dualip_tpu_torch.sparse.rowmajor import build_row_layout_sharded

                # the shape pass covers every shard; this rank routes its own
                (self.row_layout,) = build_row_layout_sharded(
                    bcsc, n_shards, plan_cache_dir=plan_cache_dir, local_range=(mesh.rank, mesh.rank + 1),
                    compact=compact, device=self.device)
            elif layout in ("row", "butterfly"):
                from dualip_tpu_torch.sparse.rowmajor import build_row_layout

                self.row_layout = build_row_layout(  # host tiles
                    bcsc,
                    method="butterfly" if layout == "butterfly" else "gather",
                    plan_cache_dir=plan_cache_dir,
                    compact=compact,
                    device=self.device,
                )
            rl = self.row_layout
            if use_cache and rl.plan_cache_path is not None:  # a miss: save beside the routing's plan file
                if mesh is not None:  # every rank writes its slice of the stacked entry
                    tile_cache.save_sharded_butterfly_state(tile_cache_dir, self.tile_cache_key, bcsc, rl, mesh)
                else:
                    tile_cache.save_butterfly_state(tile_cache_dir, self.tile_cache_key, bcsc, rl,
                                                    rl.plan_cache_path)
        if layout == "butterfly" and not keep_col_tiles:
            # the butterfly hot path never reads the (K, L) column tiles (the
            # layout carries panel copies)
            self.bcsc = BlockCSC(tiles=[], specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz,
                                 value_dtype=bcsc.value_dtype)
        else:
            if use_pallas:
                bcsc = transpose_tiles(bcsc)
            if mesh is not None and shard is None:  # this rank's columns of every tile; the specs stay global
                from dualip_tpu_torch.sparse.rowmajor import _slice_bcsc_cols

                bcsc = _slice_bcsc_cols(bcsc, mesh.rank, n_shards)
            # the segment-sum's plan serves the csc layout only
            self.bcsc = device_put_blockcsc(bcsc, self.device, row_sum=layout == "csc")
        if srow_gather:
            self.row_layout.srow_colidx = route_row_ids(self.row_layout, self.bcsc.m)
        # the panel kernel's tile table, built once with the layout
        self.panel_table = layout_panel_table(self.row_layout, bcsc.specs) if layout == "butterfly" else None
        # every input in the objective's dtype (numpy float64 b would
        # otherwise stay float64 in torch); bfloat16 rounds b as the JAX
        # package does, kept in float32
        self.b_vec = None
        if args.b_vec is not None:
            b = round_bfloat16(args.b_vec) if is_bfloat16(dtype) else np.asarray(args.b_vec, dtype=dtype)
            self.b_vec = torch.as_tensor(b, device=self.device)

    @property
    def params(self):
        return (self.bcsc, self.b_vec, self.row_layout)

    def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
        if row_layout is not None:
            return matching_local_parts_rowmajor(
                bcsc, row_layout, dual_val, gamma, block_k=self.pallas_block_k,
                carry_dtype=self.carry_dtype, want_primal=want_primal, panel_table=self.panel_table,
            )
        if self.use_pallas:
            return matching_local_parts_pallas(bcsc, dual_val, gamma, self.pallas_block_k, want_primal)
        return matching_local_parts(bcsc, dual_val, gamma, want_primal)

    def calculate_traceable(self, params, dual_val: torch.Tensor, gamma) -> ObjectiveResult:
        bcsc, b_vec, row_layout = params
        g = self.gamma if gamma is None else gamma
        grad, dual_obj, reg, _ = self._local(bcsc, dual_val, g, row_layout=row_layout)
        if self.mesh is not None:
            grad, dual_obj, reg = reduce_parts(self.mesh, grad, dual_obj, reg)
            profiling.mark("reduced")
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
        n_shards, bcsc = 1, self.bcsc
        if self.mesh is not None:
            grad, dual_obj, reg = reduce_parts(self.mesh, grad, dual_obj, reg)
            # the ranks' x in rank order: K is the last axis of (L, K) tiles, the first otherwise
            axis = 1 if (self.use_pallas and self.layout == "csc") else 0
            xs = [torch.cat(self.mesh.all_gather(x), dim=axis) for x in xs]
            n_shards = self.mesh.world_size
            if self.layout == "csc":  # a rank keeps its own columns' flat_idx: the ranks' in rank order
                bcsc = dataclasses.replace(bcsc, specs=[_gathered_flat_idx(self.mesh, s) for s in bcsc.specs])
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
                x = _panel_x_to_kl(x, spec.K, pk, n_shards)
            elif self.use_pallas:
                x = x.T  # (L, K) transposed-tile form
            xs_kl.append(x)
        res.primal_var = tiles_values_to_flat(bcsc, xs_kl)
        return res

    def exact_certificate(self, dual_val, gamma: Optional[float] = None) -> dict:
        """A certified optimality gap of the matching LP at ``dual_val``
        (simplex-inequality polytopes).  Both sides are closed form:

        * the exact dual lower bound (weak duality at ``lambda >= 0``): a
          linear program over {x >= 0, sum x <= radius} attains its minimum at
          a vertex or at 0, so ``g0 = -lambda.b - gamma * sum_i radius_i *
          max(0, max_k z_ik)`` (``z = -r/gamma``, r the reduced costs);
        * a feasible primal upper bound: the gamma-subproblem's primal, each
          nonzero of a violated row r scaled by ``b_r / (A x)_r <= 1`` (each
          nonzero lies in one row; needs A >= 0 and b > 0, as the matching
          workload has).

        Returns floats: ``primal_ub``, ``dual_lb``, ``gap_abs``, ``gap_rel``
        (``|p - d| / (1 + |p| + |d|)``) and ``max_row_violation`` (before the
        repair)."""
        if self.b_vec is None:
            raise ValueError("exact_certificate needs the finalized objective (b_vec)")
        if self.mesh is not None:
            raise NotImplementedError("exact_certificate runs on a single mesh device")
        if self.equality_mask is not None:
            raise NotImplementedError(
                "exact_certificate covers inequality rows only (the scaling repair cannot restore equality rows)")
        kinds = {spec.proj_type for spec in self.bcsc.specs}
        if kinds - {"simplex"}:
            raise NotImplementedError(
                f"exact_certificate supports simplex-inequality polytopes only (got {sorted(kinds)}); box "
                f"polytopes are covered by the general-LP PDLP certificate (objectives/miplib.py)")
        g = self.gamma if gamma is None else gamma
        dv = torch.clamp_min(torch.as_tensor(dual_val, device=self.device).to(torch.float32), 0.0)  # lambda >= 0
        rl = self.row_layout
        if rl is not None and rl.plan is not None:
            term, cxrow, ax = matching_exact_cert_rowmajor(self.bcsc, rl, dv, g)
        else:
            if not self.bcsc.tiles:
                raise ValueError("exact_certificate on the csc formulation needs the column tiles")
            bcsc = self.bcsc
            if bcsc.row_sum is None:  # the row layout in gather mode keeps no segment-sum plan
                plan = build_row_sum_plan([t.rows.cpu().numpy() for t in bcsc.tiles],
                                          [t.length.cpu().numpy() for t in bcsc.tiles], bcsc.m, bcsc.transposed)
                bcsc = dataclasses.replace(bcsc, row_sum=put_row_sum_plan(plan, self.device))
            term, cxrow, ax = matching_exact_cert_csc(bcsc, dv, g)
        b = self.b_vec
        s = torch.where(ax > b, b / ax, torch.ones((), dtype=ax.dtype, device=ax.device))
        p = float(torch.dot(s, cxrow))
        d = float(-torch.dot(dv, b) - _scalar(g, dv.dtype, dv.device) * term)
        gap = p - d
        return {
            "primal_ub": p,
            "dual_lb": d,
            "gap_abs": gap,
            "gap_rel": gap / (1.0 + abs(p) + abs(d)),
            "max_row_violation": float(torch.amax(ax - b)),
        }


class MatchingSolverDualObjectiveFunctionDistributed(MatchingSolverDualObjectiveFunction):
    """The reference's distributed constructor: ``(local_matching_input_args,
    b_vec, gamma, host_device)``.  As in the JAX package, the problem handed
    in is the whole one (every rank passes the same; ``b_vec`` is set beside
    it) and the objective keeps the rank's shard over ``mesh``, by default
    ``default_mesh(device=host_device)`` over the initialised process group."""

    def __init__(
        self,
        local_matching_input_args: MatchingInputArgs,
        b_vec: np.ndarray,
        gamma: float,
        host_device=None,
        batching: bool = True,
        mesh=None,
        use_pallas: bool = False,
        pallas_block_k: int = 1024,
        layout: str = "csc",
        plan_cache_dir=None,
    ):
        if mesh is None:
            from dualip_tpu_torch.parallel.mesh import default_mesh

            mesh = default_mesh(device=host_device)
        args = local_matching_input_args
        full_args = MatchingInputArgs(A=args.A, c=args.c, projection_map=args.projection_map,
                                      b_vec=np.asarray(b_vec), equality_mask=args.equality_mask)
        super().__init__(full_args, gamma=gamma, batching=batching, mesh=mesh, use_pallas=use_pallas,
                         pallas_block_k=pallas_block_k, layout=layout, plan_cache_dir=plan_cache_dir,
                         device=host_device)
