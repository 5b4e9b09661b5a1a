"""BlockCSC: the tile layout of block-separable LPs
(``dualip_tpu/sparse/bcsc.py``).

Entity columns are bucketed once at ingestion by power-of-2 nnz into dense
zero-padded tiles ``Tile(rows, a, c, length, col_ids)`` with ``rows/a/c`` of
shape ``(K, L)``: ``K`` columns in the (projection entry x nnz bucket)
group, ``L`` the largest column degree in it.  Padding lanes hold
``a = c = 0`` and ``rows = 0``; padding columns (``pad_cols_to``) have
``length = 0`` and contribute zero.

``rows`` is int32 here at every ``m``: ``index_select`` and ``index_add_``
take int32 or int64 indices, not the uint16 the JAX package stores for
``m <= 65535``.  Tiles of at least ``NATIVE_FILL_SLOTS`` slots are filled in
parallel by the native data plane (``io/native_loader.py::fill_tile_native``,
the JAX package's threshold), smaller ones and every tile without the library
by numpy; both give the same arrays element for element.

Tiles in bfloat16 (``dtype`` ``torch.bfloat16``, ``"bfloat16"`` or a numpy
dtype of that name) are rounded on the host to the nearest bfloat16, ties to
even, as the JAX package's are, and kept there as float32 arrays that hold
those values exactly; ``BlockCSC.value_dtype`` says the device takes them in
bfloat16.  Numpy bfloat16 arrays from another package go to the device through
a 16-bit view (``host_tensor``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dualip_tpu_torch.projections.base import ProjectionEntry, project
from dualip_tpu_torch.sparse.csc import CSCMatrix, same_pattern
from dualip_tpu_torch.utils import profiling


class Tile(NamedTuple):
    """One (projection entry x nnz bucket) group of entity columns; numpy
    arrays on the host, tensors once placed on a device."""

    rows: object  # (K, L) int32: constraint-row index (0 on padding)
    a: object  # (K, L): A values (0 on padding)
    c: object  # (K, L): c values (0 on padding)
    length: object  # (K,) int32: valid nnz per column (0 for padding columns)
    col_ids: object  # (K,) int32: global column id (-1 for padding columns)


@dataclass(frozen=True)
class TileSpec:
    """Static host-side metadata for one tile."""

    entry_key: str
    proj_type: str
    proj_params: Tuple[Tuple[str, float], ...]  # sorted, hashable
    K: int
    L: int
    # Host-only map tile position -> flat CSC nnz index (primal scatter-back).
    flat_idx: Optional[np.ndarray] = field(default=None, compare=False, repr=False)

    def projection(self):
        return project(self.proj_type, **dict(self.proj_params))


# The segment-sum's windows (``ops/segment_sum.py``).  The kernel gathers a*x
# in random row order; a window's a*x (8 MiB of slots, padding included) stays
# well inside the H100's 50 MB L2 while the warps that walk it run, so each
# 32 B sector comes from device memory once and the other gathers hit L2.  On
# an H100, windows of 4 to 16 MiB measured alike, larger ones slower, and no
# windows far slower; short segments and items (more warps in flight on L2's
# random sectors) measured faster than long ones.
WINDOW_BYTES = 8 << 20
SEG_MAX = 512  # a row's slots in one window are cut into segments of at most this many
ITEM_SLOTS = 128  # a work item (one warp) takes the segments that start in one such run of slots


class RowSumPlan(NamedTuple):
    """The fixed-order row segment-sum of every tile's a*x at once, over the
    tiles' a*x laid end to end in one flat buffer (tile i at ``offsets[i]``).
    Static: built once on the host with the tiles.

    The tiles' columns are cut into windows (``windows``: per window, its
    ``(tile, first column, end column)`` pieces, in tile and column order).
    ``order`` lists each window's valid slots, windows in order, stable-sorted
    by row within a window.  A segment is one row's run of a window in
    ``order`` (at most ``SEG_MAX`` slots); a work item is a run of segments."""

    order: object  # (V,) int32: flat slot index
    seg_ptr: object  # (S + 1,) int32: segment s is order[seg_ptr[s]:seg_ptr[s + 1]]
    seg_row: object  # (S,) int32: the row of segment s
    item_ptr: object  # (I + 1,) int32: item i is segments item_ptr[i]:item_ptr[i + 1]
    row_ptr: object  # (m + 1,) int32: row r's segments are row_segs[row_ptr[r]:row_ptr[r + 1]]
    row_segs: object  # (S,) int32: segments by row, in window order within a row
    offsets: Tuple[int, ...]  # first slot of each tile in the flat buffer
    slots: int  # length of the flat buffer
    windows: Tuple[Tuple[Tuple[int, int, int], ...], ...]


@dataclass
class BlockCSC:
    tiles: List[Tile]
    specs: List[TileSpec]
    m: int
    n: int
    nnz: int
    transposed: bool = False  # tiles hold (L, K) arrays (``transpose_tiles``)
    row_sum: Optional[RowSumPlan] = None  # csc layouts on a device
    value_dtype: Optional[torch.dtype] = None  # a and c on the device when the host arrays are wider


def is_bfloat16(dtype) -> bool:
    """``dtype`` names bfloat16: ``torch.bfloat16``, the string, or a numpy
    dtype (or scalar type) of that name."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    if isinstance(dtype, str):
        return dtype == "bfloat16"
    return getattr(dtype, "name", None) == "bfloat16" or getattr(dtype, "__name__", None) == "bfloat16"


def round_bfloat16(x) -> np.ndarray:
    """float32 array of ``x`` rounded to the nearest bfloat16, ties to even
    (bfloat16 values are float32 values, so the array holds them exactly)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def host_tensor(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (a copy), then in ``dtype``.
    A numpy bfloat16 array goes through its 16-bit view, bit for bit."""
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.as_tensor(x)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _pow2_thresholds(max_nnz: int) -> np.ndarray:
    """Bucket boundaries ``[0, 2, 4, ..., 2^k <= max_nnz, max_nnz+1]``."""
    th = [0]
    p = 2
    while p <= max_nnz:
        th.append(p)
        p *= 2
    th.append(max_nnz + 1)
    return np.asarray(th, dtype=np.int64)


def _geom_thresholds(max_nnz: int, ratio: float = 1.05) -> np.ndarray:
    """Geometric bucket boundaries: per-bucket padding bounded by
    ``ratio - 1`` (the compact layout's row-side bucketing)."""
    th = [0]
    v = 1
    while v <= max_nnz:
        th.append(v)
        v = max(v + 1, int(np.ceil(v * ratio)))
    th.append(max_nnz + 1)
    return np.unique(np.asarray(th, dtype=np.int64))


def _exact_thresholds(lengths: np.ndarray) -> np.ndarray:
    """One bucket per distinct column degree: no within-bucket padding."""
    uniq = np.unique(lengths[lengths > 0]).astype(np.int64)
    return np.concatenate([[0], uniq, [uniq[-1] + 1] if uniq.size else [1]])


NATIVE_FILL_SLOTS = 1 << 20  # K_valid * L from which a tile is filled natively


def _build_tile(
    A: CSCMatrix,
    C: CSCMatrix,
    cols: np.ndarray,
    entry_key: str,
    proj_type: str,
    proj_params: Dict,
    pad_cols_to: int,
    keep_flat_idx: bool,
    dtype,
    shard: Optional[Tuple[int, int]] = None,
) -> Tuple[Tile, TileSpec]:
    lens = (A.indptr[cols + 1] - A.indptr[cols]).astype(np.int64)  # these columns only: col_lengths diffs all n
    K = -(-len(cols) // pad_cols_to) * pad_cols_to
    L = int(lens.max())

    bf16 = is_bfloat16(dtype)
    # the whole tile's size picks the fill, so a shard is filled as the whole build fills it;
    # the native fill writes float32 a and c, so it serves float32 and bfloat16 tiles
    use_native = len(cols) * L >= NATIVE_FILL_SLOTS and (bf16 or np.dtype(dtype) == np.float32)
    K_fill = K
    if shard is not None:  # columns [d*K/D, (d+1)*K/D) of the tile: real ones, then padding
        d, D = shard
        if K % D:
            raise ValueError(f"tile K={K} not divisible by {D} shards")
        K_fill = K // D
        cols, lens = cols[d * K_fill:(d + 1) * K_fill], lens[d * K_fill:(d + 1) * K_fill]
        profiling.count("dualip.build.shard_columns", K_fill)
        profiling.count("dualip.build.shard_slots", K_fill * L)
    K_valid = len(cols)

    native = None
    if use_native:
        from dualip_tpu_torch.io.native_loader import fill_tile_native

        native = fill_tile_native(A.indptr, A.row_indices, A.data, C.data, cols, K_fill, L, keep_flat_idx)
    if native is not None:
        rows, a, c, length, col_ids, flat_idx = native
    else:
        starts = A.indptr[cols]
        total = int(lens.sum())
        cols_rep = np.repeat(np.arange(K_valid), lens)
        prefix = np.cumsum(lens) - lens
        idx_in_col = np.arange(total) - prefix[cols_rep]
        flat = starts[cols_rep] + idx_in_col

        rows = np.zeros((K_fill, L), dtype=np.int32)
        a = np.zeros((K_fill, L), dtype=np.float32 if bf16 else dtype)
        c = np.zeros((K_fill, L), dtype=np.float32 if bf16 else dtype)
        rows[cols_rep, idx_in_col] = A.row_indices[flat]
        a[cols_rep, idx_in_col] = A.data[flat]
        c[cols_rep, idx_in_col] = C.data[flat]

        length = np.zeros(K_fill, dtype=np.int32)
        length[:K_valid] = lens
        col_ids = np.full(K_fill, -1, dtype=np.int32)
        col_ids[:K_valid] = cols

        flat_idx = None
        if keep_flat_idx:
            flat_idx = np.full((K_fill, L), -1, dtype=np.int64)
            flat_idx[cols_rep, idx_in_col] = flat
    if bf16:
        a, c = round_bfloat16(a), round_bfloat16(c)

    spec = TileSpec(
        entry_key=entry_key,
        proj_type=proj_type,
        proj_params=tuple(sorted(proj_params.items())),
        K=K,
        L=L,
        flat_idx=flat_idx,
    )
    return Tile(rows=rows, a=a, c=c, length=length, col_ids=col_ids), spec


@profiling.timed("dualip.build.tiles")
def build_blockcsc(
    A: CSCMatrix,
    C: CSCMatrix,
    projection_map: Dict[str, ProjectionEntry],
    batching: bool = True,
    pad_cols_to: int = 1,
    keep_flat_idx: bool = True,
    dtype=np.float32,
    bucketing: str = "pow2",
    shard: Optional[Tuple[int, int]] = None,
) -> BlockCSC:
    """Bucket the columns of same-pattern (A, c) into host projection tiles.

    ``batching=True`` groups each entry's columns by nnz buckets; ``False``
    keeps one tile per entry.  ``bucketing`` selects the boundaries: ``"pow2"``
    or ``"exact"`` (one bucket per distinct degree, the compact butterfly
    layout's column rule).  Empty columns are dropped; columns no entry covers
    get the identity projection.  A bfloat16 ``dtype`` in any of its forms
    rounds a and c (see the module's docstring).

    ``shard=(d, D)`` builds rank d's part of the entity-sharded tiles only:
    the buckets, the specs' K and L, ``m``, ``n`` and ``nnz`` are the whole
    build's, and each tile holds columns ``[d*K/D, (d+1)*K/D)`` of the whole
    build's tile (each K must divide by D: ``pad_cols_to`` a multiple of it),
    element for element ``rowmajor._slice_bcsc_cols(build_blockcsc(...), d,
    D)``.  Each spec's ``flat_idx`` is that slab's (K/D, L), still holding
    global flat positions.  The inputs are only read; the counters
    ``dualip.build.shard_columns`` and ``dualip.build.shard_slots`` add the
    columns (real and padding) and slots filled.
    """
    if not same_pattern(A, C):
        raise ValueError("A and c must share the same CSC sparsity pattern")
    m, n = A.shape
    lengths = A.col_lengths
    has_empty = bool((lengths == 0).any())
    if bucketing == "exact":
        thresholds = _exact_thresholds(lengths)
    elif bucketing == "pow2":
        thresholds = _pow2_thresholds(m)
    else:
        raise ValueError(f"Unknown bucketing {bucketing!r} (expected 'pow2' or 'exact')")
    # index i with th[i-1] < len <= th[i]
    bucket_ids = np.searchsorted(thresholds, lengths, side="left")

    covered = np.zeros(n, dtype=bool)
    tiles: List[Tile] = []
    specs: List[TileSpec] = []

    def add_entry(entry_key: str, proj_type: str, proj_params: Dict, indices: np.ndarray):
        if has_empty and len(indices):
            indices = indices[lengths[indices] > 0]
        if len(indices) == 0:
            return
        groups = [indices]
        if batching:
            ids = bucket_ids[indices]
            groups = [indices[ids == j] for j in range(1, len(thresholds))]
        for cols in groups:
            if len(cols) == 0:
                continue
            t, s = _build_tile(
                A, C, cols, entry_key, proj_type, proj_params, pad_cols_to, keep_flat_idx, dtype, shard
            )
            tiles.append(t)
            specs.append(s)

    for key, entry in projection_map.items():
        idx = np.asarray(entry.indices, dtype=np.int64)
        if covered[idx].any():
            raise ValueError(f"Projection entry '{key}' overlaps a previously covered column")
        covered[idx] = True
        add_entry(key, entry.proj_type, dict(entry.proj_params), idx)

    uncovered = np.nonzero(~covered)[0]
    add_entry("__identity__", "identity", {}, uncovered)

    return BlockCSC(tiles=tiles, specs=specs, m=m, n=n, nnz=A.nnz,
                    value_dtype=torch.bfloat16 if is_bfloat16(dtype) else None)


def _windows(shapes: Sequence[Tuple[int, int]], cap_slots: int):
    """Cut the tiles' columns, in order, into windows of at most ``cap_slots``
    slots (L per column); a column wider than the cap is a window alone."""
    windows, cur, used = [], [], 0
    for i, (L, K) in enumerate(shapes):
        k = 0
        while k < K:
            room = (cap_slots - used) // L
            if room == 0 and cur:
                windows.append(tuple(cur))
                cur, used = [], 0
                continue
            take = min(max(room, 1), K - k)
            cur.append((i, k, k + take))
            used += take * L
            k += take
    if cur:
        windows.append(tuple(cur))
    return tuple(windows)


@profiling.timed("dualip.build.rows")
def build_row_sum_plan(
    rows: Sequence[np.ndarray], lengths: Sequence[np.ndarray], m: int, transposed: bool = False,
    window_bytes: int = WINDOW_BYTES,
) -> RowSumPlan:
    """Host ``RowSumPlan`` of the tiles whose ``rows`` are (K, L), or (L, K)
    with ``transposed``, and whose column lengths are ``lengths``."""
    shapes = [(r.shape[0], r.shape[1]) if transposed else (r.shape[1], r.shape[0]) for r in rows]
    sizes = [L * K for L, K in shapes]
    offsets = tuple(int(v) for v in np.cumsum([0] + sizes[:-1]))
    slots = int(sum(sizes))
    if slots >= 2**31:
        raise ValueError(f"{slots} tile slots: the segment-sum indexes them with int32")
    windows = _windows(shapes, max(1, window_bytes // 4))
    key_dt = np.uint16 if m <= np.iinfo(np.uint16).max else np.int32  # 16-bit keys sort by radix
    orders, counts = [], []
    for win in windows:
        w_slots, w_rows = [], []
        for i, k0, k1 in win:
            (L, K), r, n = shapes[i], np.asarray(rows[i]), np.asarray(lengths[i])[k0:k1]
            lane = np.arange(L)
            if transposed:  # slot l*K + k, ascending in (l, k)
                valid = lane[:, None] < n[None, :]
                l, k = np.nonzero(valid)
                w_slots.append(offsets[i] + l.astype(np.int64) * K + (k + k0))
                w_rows.append(r[:, k0:k1][valid])
            else:  # slot k*L + l, ascending in (k, l)
                valid = lane[None, :] < n[:, None]
                k, l = np.nonzero(valid)
                w_slots.append(offsets[i] + (k + k0).astype(np.int64) * L + l)
                w_rows.append(r[k0:k1][valid])
        keys = np.concatenate(w_rows).astype(key_dt, copy=False)
        orders.append(np.concatenate(w_slots)[np.argsort(keys, kind="stable")].astype(np.int32))
        counts.append(np.bincount(keys, minlength=m))
    order = np.concatenate(orders) if orders else np.zeros(0, np.int32)
    # segments: each (window, row) with slots, cut into pieces of at most SEG_MAX
    cnt = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    pieces = -(-cnt // SEG_MAX)
    seg_row = np.repeat(np.tile(np.arange(m, dtype=np.int32), len(windows)), pieces)
    seg_len = np.full(seg_row.size, SEG_MAX, dtype=np.int64)
    has = pieces > 0
    seg_len[np.cumsum(pieces)[has] - 1] = cnt[has] - (pieces[has] - 1) * SEG_MAX
    seg_ptr = np.concatenate([[0], np.cumsum(seg_len)])
    group = seg_ptr[:-1] // ITEM_SLOTS
    item_ptr = np.concatenate([[0], np.flatnonzero(np.diff(group)) + 1, [seg_row.size]]) if seg_row.size else np.zeros(1)
    row_segs = np.argsort(seg_row, kind="stable")
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(seg_row, minlength=m))])
    i32 = lambda v: np.asarray(v).astype(np.int32)  # noqa: E731
    return RowSumPlan(
        order=order, seg_ptr=i32(seg_ptr), seg_row=seg_row, item_ptr=i32(item_ptr), row_ptr=i32(row_ptr),
        row_segs=i32(row_segs), offsets=offsets, slots=slots, windows=windows,
    )


def put_row_sum_plan(plan: RowSumPlan, device) -> RowSumPlan:
    """A host ``RowSumPlan`` with its index arrays on ``device``."""
    return plan._replace(**{f: host_tensor(getattr(plan, f), device)
                            for f in ("order", "seg_ptr", "seg_row", "item_ptr", "row_ptr", "row_segs")})


def device_put_blockcsc(bcsc: BlockCSC, device, row_sum: bool = False) -> BlockCSC:
    """Copy every tile array to ``device`` as a tensor (rows widened to int32,
    a and c in ``bcsc.value_dtype`` where it is set).  ``row_sum=True`` also
    builds the tiles' ``RowSumPlan`` on the host (the span
    ``dualip.build.rows``) and places it beside the tiles; the copies are the
    span ``dualip.build.upload``."""

    def put(x, dtype=None):
        return host_tensor(x, device, dtype)

    plan = None
    if row_sum:
        plan = build_row_sum_plan([t.rows for t in bcsc.tiles], [t.length for t in bcsc.tiles], bcsc.m,
                                  bcsc.transposed)
    with profiling.span("dualip.build.upload", always=True):
        if plan is not None:
            plan = put_row_sum_plan(plan, device)
        tiles = [
            Tile(
                rows=put(t.rows, torch.int32),
                a=put(t.a, bcsc.value_dtype),
                c=put(t.c, bcsc.value_dtype),
                length=put(t.length, torch.int32),
                col_ids=put(t.col_ids, torch.int32),
            )
            for t in bcsc.tiles
        ]
    return BlockCSC(
        tiles=tiles, specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz,
        transposed=bcsc.transposed, row_sum=plan, value_dtype=bcsc.value_dtype,
    )


def blockcsc_from_numpy(tiles, specs, m: int, n: int, nnz: int, device, transposed: bool = False,
                        row_sum: bool = False) -> BlockCSC:
    """The port's BlockCSC from another builder's leaves as numpy arrays.

    ``tiles`` holds ``(rows, a, c, length, col_ids)`` per tile (the JAX
    package's ``Tile`` fields, e.g. its uint16 ``rows``, which are widened
    to int32); ``specs`` needs ``entry_key, proj_type, proj_params, K, L``
    and ``flat_idx``.  ``transposed`` says the arrays are (L, K);
    ``row_sum`` builds the segment-sum's ``RowSumPlan`` as well.
    """
    host_tiles = [Tile(*(np.asarray(x) for x in t)) for t in tiles]
    port_specs = [
        TileSpec(
            entry_key=s.entry_key,
            proj_type=s.proj_type,
            proj_params=tuple(s.proj_params),
            K=int(s.K),
            L=int(s.L),
            flat_idx=s.flat_idx,
        )
        for s in specs
    ]
    return device_put_blockcsc(
        BlockCSC(tiles=host_tiles, specs=port_specs, m=m, n=n, nnz=nnz, transposed=transposed),
        device, row_sum=row_sum,
    )


def tile_valid_mask(tile: Tile, L: int) -> torch.Tensor:
    """(K, L) bool mask of real (non-padding) entries."""
    lane = torch.arange(L, device=tile.length.device, dtype=torch.int32)
    return lane[None, :] < tile.length[:, None]


def apply_projections(bcsc: BlockCSC, values: Sequence[torch.Tensor], mask_output: bool = True) -> List[torch.Tensor]:
    """Each tile's registered projection on its (K, L) value block; with
    ``mask_output`` the padding lanes are zeroed afterwards."""
    out = []
    for tile, spec, v in zip(bcsc.tiles, bcsc.specs, values):
        x = spec.projection()(v)
        if mask_output:
            x = torch.where(tile_valid_mask(tile, spec.L), x, torch.zeros((), dtype=x.dtype, device=x.device))
        out.append(x)
    return out


def tiles_values_to_flat(bcsc: BlockCSC, values: Sequence[np.ndarray]) -> np.ndarray:
    """Scatter per-tile (K, L) value blocks back to a flat CSC-ordered nnz
    vector on the host.  Needs ``keep_flat_idx=True``."""
    flat = np.zeros(bcsc.nnz, dtype=np.asarray(values[0]).dtype)
    for spec, v in zip(bcsc.specs, values):
        if spec.flat_idx is None:
            raise ValueError("BlockCSC was built with keep_flat_idx=False")
        sel = spec.flat_idx >= 0
        flat[spec.flat_idx[sel]] = np.asarray(v)[sel]
    return flat


def flat_to_tiles_values(bcsc: BlockCSC, flat: np.ndarray, dtype=None) -> List[np.ndarray]:
    """Gather a flat CSC-ordered nnz vector into per-tile (K, L) value blocks
    on the host (zero on padding).  Needs ``keep_flat_idx=True``."""
    out = []
    dtype = dtype or np.asarray(flat).dtype
    for spec in bcsc.specs:
        if spec.flat_idx is None:
            raise ValueError("BlockCSC was built with keep_flat_idx=False")
        v = np.zeros((spec.K, spec.L), dtype=dtype)
        sel = spec.flat_idx >= 0
        v[sel] = np.asarray(flat)[spec.flat_idx[sel]]
        out.append(v)
    return out
