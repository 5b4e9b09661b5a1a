"""Row-major companion layout of a BlockCSC (``dualip_tpu/sparse/rowmajor.py``).

A second, row-major view of the same nonzeros, built once at ingestion (all
indices static).  **Row tiles** group each constraint row's nonzeros into dense
``(R, Lr)`` blocks, so the dual value of a slot is a broadcast along its row
and the per-row gradient sum is a dense lane reduction.  The projection still
needs the column grouping, so the two layouts are connected by a static
permutation:

* ``method="gather"``: per-nnz index arrays (``zidx`` carries row-computed z
  into each column tile, ``RowTile.axidx`` carries ``a*x`` back);
* ``method="butterfly"``: one Benes plan (``ops/butterfly.py``) routes row
  space to column space in panel order, and the same plan walked backwards
  carries ``a*x`` back.

The layout exists in the JAX package because a TPU has neither gather nor
scatter hardware.  An NVIDIA GPU has both; the port keeps the layout because
it is a supported layout of the solver, not because the card needs it.

Single device only; the sharded layout belongs to the distributed slice.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dualip_tpu_torch.ops.butterfly import (
    benes_plan_from_numpy,
    benes_plan_packed_from_numpy,
    benes_route_planes,
    pack_plan_from_planes,
)
from dualip_tpu_torch.sparse.bcsc import _geom_thresholds, _pow2_thresholds


class RowTile(NamedTuple):
    """One bucket of constraint rows, row-major.

    Gather mode: ``a``/``c`` are the A/c values of each row's nonzeros (0 on
    padding) and ``axidx`` the position of each slot's nonzero in the
    concatenated column-tile ``a*x`` vector (sentinel on padding).

    Butterfly mode: ``a``/``c``/``axidx`` are ``None``: the forward carry ships
    only the masked dual broadcast ``srow = (-lambda/gamma)[row_id]`` and the
    panel kernel computes z from the column-side a/c.  ``length`` masks the
    broadcast (padding slots must carry zeros).

    ``row_ids`` is the global constraint-row id per tile row (0 on padding)."""

    a: Optional[torch.Tensor]  # (R, Lr) | None (butterfly)
    c: Optional[torch.Tensor]  # (R, Lr) | None (butterfly)
    row_ids: torch.Tensor  # (R,) int32
    axidx: Optional[torch.Tensor]  # (R, Lr) int32 | None (butterfly)
    length: Optional[torch.Tensor] = None  # (R,) int32 (butterfly) | None (gather)


class PanelTile(NamedTuple):
    """Panel-form a/c of one column tile (butterfly mode only).

    The butterfly column space stores tile ``t`` as ``K/128`` panels of
    ``(L2, 128)``: the flat position of column ``k``, lane ``l`` is
    ``off_t + (k>>7)*(128*L2) + l*128 + (k&127)`` with ``L2 = next_pow2(L)``.
    With offsets assigned in descending-``L2`` order every tile's region of the
    carry buffer is rows ``[off/(128*L2), .)`` of ``buf.view(-1, L2, 128)``, so
    the panel kernel reads and writes the carry buffer directly
    (``ops/fused_matching.py::fused_panel_project``).  ``a``/``c`` carry only
    the real lanes; the ghost lanes exist only in the buffer."""

    a: torch.Tensor  # (K//128, L, 128), or (BP, q*L, 128) on the compact packing
    c: torch.Tensor
    length: torch.Tensor  # (K//128, 1, 128) int32, or (BP, q, 128)


def _pack_geometry(L: int, max_l2: int = 512, max_q: int = 64):
    """(L2, q) of the compact column packing: q = L2//L columns of length L
    share one L2-lane buffer row.  The smallest pow2 L2 whose waste
    (L2 - q*L)/L2 drops to <= 1/32, else the argmin; L=34 gives L2=512, q=15.
    Caps: L2 <= 512 and q <= 64."""
    cand = 1 << max(L - 1, 0).bit_length() if L > 1 else 1
    best = None
    while cand <= max_l2 and cand // L <= max_q:
        q = cand // L
        waste = (cand - q * L) / cand
        if best is None or waste < best[0] - 1e-12:
            best = (waste, cand, q)
        if waste <= 1 / 32:
            break
        cand *= 2
    if best is None:  # L > max_l2: one column per pow2 row
        return 1 << max(L - 1, 0).bit_length(), 1
    return best[1], best[2]


def _col_geometry(K: int, L: int, compact: bool):
    """Panel-region geometry of one (K, L) column tile: ``(L2, q, BP)``, q
    columns of length L per L2-lane buffer row, BP buffer rows (region size
    BP*L2*128 flat slots)."""
    if compact:
        L2, q = _pack_geometry(L)
    else:
        L2, q = (1 << max(L - 1, 0).bit_length()) if L > 1 else 1, 1
    pr = K // 128  # panel rows (128 columns each)
    BP = -(-pr // q)  # buffer rows (q panel rows share one)
    if q > 1:
        BP = -(-BP // 8) * 8  # as the JAX package pads them, so the layouts stay equal
    return L2, q, BP


@dataclass
class RowLayout:
    """Static companion indices for one BlockCSC.

    Gather mode: ``zidx[t]`` has the column tile's (K, L) shape and indexes the
    concatenated row-tile z vector (+ trailing sentinel zero).

    Butterfly mode: ``plan`` routes row space to column space in panel order
    (a ``BenesPlanPacked`` when the layout lives on a CUDA device, a
    ``BenesPlan`` on the CPU); ``col_tiles_T`` holds the panel-form a/c;
    ``col_offsets`` the static flat start of each tile's region; ``col_pack``
    the per-tile (L, L2, q) on the compact packing.  ``srow_colidx`` (N,) int32
    holds, per carry-buffer slot, the constraint-row id whose scaled dual lands
    there (sentinel m on padding): the forward carry's constant action on the
    row-id broadcast (``srow_gather``).

    ``row_pos`` (m,) indexes the concatenated per-row sums (+ sentinel)."""

    row_tiles: List[RowTile]
    zidx: Optional[List[torch.Tensor]]
    row_pos: torch.Tensor  # (m,) int32
    plan: Optional[object] = None  # BenesPlan | BenesPlanPacked
    col_tiles_T: Optional[List[PanelTile]] = None
    use_cuda_kernel: bool = False  # the layout's tensors are on a CUDA device
    col_offsets: Optional[tuple] = None
    row_shapes: Optional[tuple] = None  # static ((R, Lr), ...) per row tile
    col_pack: Optional[tuple] = None
    srow_colidx: Optional[torch.Tensor] = None
    plan_cache_path: Optional[str] = None  # the plan-cache file of this layout's routing
    build_seconds: Optional[dict] = None  # host seconds: {"route": ..., "total": ...}


def build_row_layout(
    bcsc,
    method: str = "gather",
    plan_cache_dir=None,
    compact: bool = False,
    device="cpu",
) -> RowLayout:
    """Build the row-major companion of a host-side BlockCSC (numpy tiles, in
    (K, L) form) and place it on ``device``.

    ``plan_cache_dir`` (butterfly only) caches the routed plan on disk keyed by
    a hash of the permutation.  ``compact=True`` (butterfly only): q = L2//L
    columns share each pow2 buffer row and the row side buckets geometrically
    (1.05x); build the BlockCSC with ``bucketing="exact"``.  On a CUDA device
    the plan is packed for the kernels (``ops/butterfly.py::DEFAULT_BLOCK_LOG2``)."""
    if method not in ("gather", "butterfly"):
        raise ValueError(f"Unknown row-layout method {method!r}")
    if compact and method != "butterfly":
        raise ValueError("compact packing is butterfly-only")
    t_start = time.perf_counter()
    device = torch.device(device)
    m = bcsc.m

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    transposed = method == "butterfly"
    if transposed:
        KLs = []  # (K, L, L2, q, BP)
        for tile in bcsc.tiles:
            K, L = np.asarray(tile.rows).shape
            if K % 128:
                raise ValueError(
                    f"butterfly layout needs tile K divisible by 128 (got K={K}); "
                    "build the BlockCSC with pad_cols_to a multiple of 128"
                )
            L2, q, BP = _col_geometry(K, L, compact)
            KLs.append((K, L, L2, q, BP))
        # descending L2, stable: off_t is then always a multiple of 128*L2_t
        order = sorted(range(len(KLs)), key=lambda i: -KLs[i][2])
        col_offsets = [0] * len(KLs)
        cum = 0
        for i in order:
            col_offsets[i] = cum
            cum += KLs[i][4] * KLs[i][2] * 128
        col_total = cum
    _hi = 4 * max(col_total if transposed else 1, bcsc.nnz, m, 2)
    pdt = np.int32 if _hi < 2**31 else np.int64
    rows_dt = np.uint16 if m <= np.iinfo(np.uint16).max else np.int32

    rows_l, a_l, c_l, axflat_l = [], [], [], []
    off = 0
    for i, tile in enumerate(bcsc.tiles):
        rows = np.asarray(tile.rows)
        K, L = rows.shape
        lane = np.arange(L, dtype=pdt)[None, :]
        valid = np.arange(L)[None, :] < np.asarray(tile.length)[:, None]
        if transposed:
            _, _, L2, q, _ = KLs[i]
            kcol = np.arange(K, dtype=pdt)[:, None]
            pr = kcol >> 7  # panel row of column k
            flat = (
                pdt(col_offsets[i])
                + (pr // q) * pdt(128 * L2)
                + ((pr % q) * pdt(L) + lane) * pdt(128)
                + (kcol & 127)
            )
        else:
            flat = off + np.arange(K * L).reshape(K, L)
            a_l.append(np.asarray(tile.a)[valid])
            c_l.append(np.asarray(tile.c)[valid])
        rows_l.append(rows[valid])
        axflat_l.append(flat[valid])
        off += K * L
    ax_sentinel = col_total if transposed else off  # trailing zero in the ax concat
    rows_all = np.concatenate(rows_l).astype(rows_dt, copy=False)
    n_nnz = rows_all.size
    del rows_l
    if not transposed:
        a_all = np.concatenate(a_l)
        c_all = np.concatenate(c_l)
    del a_l, c_l
    axflat_all = np.concatenate(axflat_l).astype(pdt, copy=False)
    del axflat_l

    # order nonzeros by constraint row (stable: keeps column order)
    order = np.argsort(rows_all, kind="stable").astype(pdt, copy=False)
    counts = np.bincount(rows_all, minlength=m)
    del rows_all
    nz_rows = np.nonzero(counts)[0]
    row_starts = np.concatenate([[0], np.cumsum(counts[nz_rows])]).astype(pdt, copy=False)

    max_count = int(counts.max()) if counts.size else 1
    thresholds = _geom_thresholds(max_count, 1.05) if compact else _pow2_thresholds(max_count)
    bucket_of = np.searchsorted(thresholds, counts[nz_rows], side="left")

    row_tiles: List[RowTile] = []
    row_shapes: List[tuple] = []
    zpos_sorted = np.empty(n_nnz, dtype=pdt)  # position in the z concat of every sorted nonzero
    sumpos = np.full(m, -1, dtype=np.int64)  # position of each present row's sum
    zoff = 0
    sumoff = 0
    for b in range(1, len(thresholds)):
        sel = np.nonzero(bucket_of == b)[0]  # indices into nz_rows
        if sel.size == 0:
            continue
        R = sel.size
        Lr = int(counts[nz_rows[sel]].max())
        lens = counts[nz_rows[sel]].astype(np.int64)
        row_ids_t = np.zeros(R, dtype=np.int32)
        row_ids_t[: sel.size] = nz_rows[sel]
        r_rep = np.repeat(np.arange(sel.size, dtype=pdt), lens)
        prefix = (np.cumsum(lens) - lens).astype(pdt, copy=False)
        l_in_row = np.arange(int(lens.sum()), dtype=pdt) - prefix[r_rep]
        sorted_pos = row_starts[sel][r_rep] + l_in_row  # index into the sorted nnz order
        zpos_sorted[sorted_pos] = pdt(zoff) + r_rep * pdt(Lr) + l_in_row
        sumpos[nz_rows[sel]] = sumoff + np.arange(sel.size)
        if method == "gather":
            src = order[sorted_pos]
            a_t = np.zeros((R, Lr), dtype=a_all.dtype)
            c_t = np.zeros((R, Lr), dtype=c_all.dtype)
            axidx_t = np.full((R, Lr), ax_sentinel, dtype=np.int64)
            a_t[r_rep, l_in_row] = a_all[src]
            c_t[r_rep, l_in_row] = c_all[src]
            axidx_t[r_rep, l_in_row] = axflat_all[src]
            row_tiles.append(
                RowTile(a=put(a_t), c=put(c_t), row_ids=put(row_ids_t), axidx=put(axidx_t.astype(np.int32)))
            )
        else:  # butterfly: srow carry, only row ids + lengths needed
            lens_t = np.zeros(R, dtype=np.int32)
            lens_t[: sel.size] = lens
            row_tiles.append(RowTile(a=None, c=None, row_ids=put(row_ids_t), axidx=None, length=put(lens_t)))
        row_shapes.append((R, Lr))
        zoff += R * Lr
        sumoff += R
    z_sentinel = zoff

    # rows with no nonzeros point at the sums sentinel (zero gradient)
    row_pos = np.where(sumpos >= 0, sumpos, sumoff).astype(np.int32)

    zpos_all = np.empty(n_nnz, dtype=pdt)
    zpos_all[order] = zpos_sorted
    del order, zpos_sorted

    if method == "butterfly":
        row_total = zoff  # = sum of R*Lr over row tiles
        N = 1 << int(np.ceil(np.log2(max(col_total, row_total, 2))))
        # sigma: row space -> column space; column padding slots pull zeros from
        # unused row-space / pad slots (bijection completion, identity-preferring)
        perm = np.full(col_total, -1, dtype=pdt)
        perm[axflat_all] = zpos_all
        del axflat_all
        used = np.zeros(N, dtype=bool)
        used[zpos_all] = True
        del zpos_all
        missing = np.nonzero(perm < 0)[0]
        fix = ~used[missing]
        perm[missing[fix]] = missing[fix]
        used[missing[fix]] = True
        rest = missing[~fix]
        perm[rest] = np.nonzero(~used)[0][: rest.size]
        del used, missing, fix, rest
        use_cuda_kernel = device.type == "cuda"
        packed = None  # (planes, dists, n_in, n_out): the cache's and the kernels' currency
        cache_path = None
        t_route = time.perf_counter()
        if plan_cache_dir is not None:
            # hash the int64 view so keys do not depend on the position dtype
            key = hashlib.sha1(np.ascontiguousarray(perm, dtype=np.int64).tobytes()).hexdigest()[:20]
            cache_path = Path(plan_cache_dir) / f"benes2_{key}_{N}_{row_total}.npz"
            if cache_path.exists():
                d = np.load(cache_path)
                packed = (
                    np.asarray(d["masks_packed"]).view(np.uint8),
                    tuple(int(x) for x in d["dists"]),
                    int(d["n_in"]),
                    int(d["n_out"]),
                )
        if packed is None:
            packed = benes_route_planes(perm, pad_to=N, n_in=row_total)
            if cache_path is not None:
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                tmp = cache_path.with_suffix(".tmp.npz")
                np.savez(
                    tmp,
                    dists=np.asarray(packed[1], dtype=np.int64),
                    masks_packed=packed[0],
                    n_stages=len(packed[1]),
                    n_in=packed[2],
                    n_out=packed[3],
                )
                tmp.replace(cache_path)  # atomic: no corrupt cache on interrupt
        route_s = time.perf_counter() - t_route
        if use_cuda_kernel:
            plan = pack_plan_from_planes(*packed, device=device)
        else:
            planes, dists, p_n_in, p_n_out = packed
            masks = np.unpackbits(planes, axis=0, count=len(dists), bitorder="little")
            plan = benes_plan_from_numpy(dists, masks, p_n_in, p_n_out, device=device)
        del packed
        col_tiles_T = []
        for i, t in enumerate(bcsc.tiles):
            a_np, c_np = np.asarray(t.a), np.asarray(t.c)
            K, L = a_np.shape
            _, _, L2, q, BP = KLs[i]
            if q == 1:
                col_tiles_T.append(
                    PanelTile(
                        # (K, L) -> (K//128, L, 128): panel p, lane l, col c = (p*128+c, l)
                        a=put(a_np.reshape(K // 128, 128, L).transpose(0, 2, 1)),
                        c=put(c_np.reshape(K // 128, 128, L).transpose(0, 2, 1)),
                        length=put(np.asarray(t.length).reshape(K // 128, 1, 128)),
                    )
                )
            else:
                # compact: q panel rows stack into each buffer row; panel rows
                # beyond K//128 are zeros with length 0
                pr = K // 128
                pad = BP * q - pr

                def _stack(x):
                    x = x.reshape(pr, 128, L).transpose(0, 2, 1)  # (pr, L, 128)
                    if pad:
                        x = np.concatenate([x, np.zeros((pad, L, 128), dtype=x.dtype)])
                    return x.reshape(BP, q * L, 128)

                lens = np.asarray(t.length).reshape(pr, 1, 128)
                if pad:
                    lens = np.concatenate([lens, np.zeros((pad, 1, 128), dtype=lens.dtype)])
                col_tiles_T.append(
                    PanelTile(a=put(_stack(a_np)), c=put(_stack(c_np)), length=put(lens.reshape(BP, q, 128)))
                )
        return RowLayout(
            row_tiles=row_tiles,
            zidx=None,
            row_pos=put(row_pos),
            plan=plan,
            col_tiles_T=col_tiles_T,
            use_cuda_kernel=use_cuda_kernel,
            col_offsets=tuple(col_offsets),
            row_shapes=tuple(row_shapes),
            col_pack=tuple((L, L2, q) for (_, L, L2, q, _) in KLs) if compact else None,
            plan_cache_path=str(cache_path) if cache_path is not None else None,
            build_seconds={"route": route_s, "total": time.perf_counter() - t_start},
        )

    # gather mode: column-tile zidx (where each column slot's z lives)
    zidx: List[torch.Tensor] = []
    pos = 0
    for tile in bcsc.tiles:
        rows = np.asarray(tile.rows)
        K, L = rows.shape
        lane = np.arange(L)[None, :]
        valid = lane < np.asarray(tile.length)[:, None]
        zi = np.full((K, L), z_sentinel, dtype=np.int64)
        nvalid = int(valid.sum())
        zi[valid] = zpos_all[pos : pos + nvalid]
        pos += nvalid
        zidx.append(put(zi.astype(np.int32)))

    return RowLayout(
        row_tiles=row_tiles, zidx=zidx, row_pos=put(row_pos), row_shapes=tuple(row_shapes),
        build_seconds={"route": 0.0, "total": time.perf_counter() - t_start},
    )


def row_layout_from_numpy(
    row_tiles, zidx, row_pos, plan=None, col_tiles_T=None, col_offsets=None, row_shapes=None,
    col_pack=None, srow_colidx=None, device="cpu",
) -> RowLayout:
    """The port's ``RowLayout`` from another package's leaves as numpy arrays
    and static tuples (the JAX package's layout).  ``row_tiles`` holds
    ``(a, c, row_ids, axidx, length)`` per tile and ``col_tiles_T``
    ``(a, c, length)``, ``None`` where the mode has none; ``plan`` is ``None``
    (gather), a dict of a ``BenesPlan``'s fields (``dists, masks, n_in,
    n_out``) or of a ``BenesPlanPacked``'s."""
    device = torch.device(device)

    def put(x, dtype=None):
        if x is None:
            return None
        # a copy: another package's arrays may be read-only
        return torch.as_tensor(np.array(x, dtype=dtype, order="C"), device=device)

    tiles = [
        RowTile(a=put(a), c=put(c), row_ids=put(r, np.int32), axidx=put(ax, np.int32), length=put(ln, np.int32))
        for a, c, r, ax, ln in row_tiles
    ]
    port_plan = None
    if plan is not None:
        if "masks" in plan:
            port_plan = benes_plan_from_numpy(plan["dists"], plan["masks"], plan["n_in"], plan["n_out"], device)
        else:
            port_plan = benes_plan_packed_from_numpy(device=device, **plan)
    return RowLayout(
        row_tiles=tiles,
        zidx=[put(z, np.int32) for z in zidx] if zidx is not None else None,
        row_pos=put(row_pos, np.int32),
        plan=port_plan,
        col_tiles_T=[PanelTile(a=put(a), c=put(c), length=put(ln, np.int32)) for a, c, ln in col_tiles_T]
        if col_tiles_T is not None else None,
        use_cuda_kernel=device.type == "cuda",
        col_offsets=tuple(col_offsets) if col_offsets is not None else None,
        row_shapes=tuple(tuple(s) for s in row_shapes) if row_shapes is not None else None,
        col_pack=tuple(tuple(p) for p in col_pack) if col_pack is not None else None,
        srow_colidx=put(srow_colidx, np.int32),
    )
