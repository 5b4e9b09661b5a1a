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
``m <= 65535``.  The tile builder is the numpy fill; the JAX package's native
parallel fill belongs to the I/O slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dualip_tpu_torch.projections.base import ProjectionEntry, project
from dualip_tpu_torch.sparse.csc import CSCMatrix, same_pattern


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


class RowOrder(NamedTuple):
    """A tile's valid slots in row-sorted order, for the fixed-order row
    segment-sum (``ops/segment_sum.py``).  Static: built once with the tile."""

    order: object  # (valid slots,) int32: flat slot index, stable-sorted by row
    ptr: object  # (m + 1,) int64: row r owns order[ptr[r]:ptr[r + 1]]


@dataclass
class BlockCSC:
    tiles: List[Tile]
    specs: List[TileSpec]
    m: int
    n: int
    nnz: int
    transposed: bool = False  # tiles hold (L, K) arrays (``transpose_tiles``)
    row_orders: Optional[List[RowOrder]] = None  # per tile, csc layouts on a device


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
) -> Tuple[Tile, TileSpec]:
    lens = A.col_lengths[cols].astype(np.int64)
    K_valid = len(cols)
    K = -(-K_valid // pad_cols_to) * pad_cols_to
    L = int(lens.max())

    starts = A.indptr[cols]
    total = int(lens.sum())
    cols_rep = np.repeat(np.arange(K_valid), lens)
    prefix = np.cumsum(lens) - lens
    idx_in_col = np.arange(total) - prefix[cols_rep]
    flat = starts[cols_rep] + idx_in_col

    rows = np.zeros((K, L), dtype=np.int32)
    a = np.zeros((K, L), dtype=dtype)
    c = np.zeros((K, L), dtype=dtype)
    rows[cols_rep, idx_in_col] = A.row_indices[flat]
    a[cols_rep, idx_in_col] = A.data[flat]
    c[cols_rep, idx_in_col] = C.data[flat]

    length = np.zeros(K, dtype=np.int32)
    length[:K_valid] = lens
    col_ids = np.full(K, -1, dtype=np.int32)
    col_ids[:K_valid] = cols

    flat_idx = None
    if keep_flat_idx:
        flat_idx = np.full((K, L), -1, dtype=np.int64)
        flat_idx[cols_rep, idx_in_col] = flat

    spec = TileSpec(
        entry_key=entry_key,
        proj_type=proj_type,
        proj_params=tuple(sorted(proj_params.items())),
        K=K,
        L=L,
        flat_idx=flat_idx,
    )
    return Tile(rows=rows, a=a, c=c, length=length, col_ids=col_ids), spec


def build_blockcsc(
    A: CSCMatrix,
    C: CSCMatrix,
    projection_map: Dict[str, ProjectionEntry],
    batching: bool = True,
    pad_cols_to: int = 1,
    keep_flat_idx: bool = True,
    dtype=np.float32,
    bucketing: str = "pow2",
) -> BlockCSC:
    """Bucket the columns of same-pattern (A, c) into host projection tiles.

    ``batching=True`` groups each entry's columns by nnz buckets; ``False``
    keeps one tile per entry.  ``bucketing`` selects the boundaries: ``"pow2"``
    or ``"exact"`` (one bucket per distinct degree, the compact butterfly
    layout's column rule).  Empty columns are dropped; columns no entry covers
    get the identity projection.
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
                A, C, cols, entry_key, proj_type, proj_params, pad_cols_to, keep_flat_idx, dtype
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

    return BlockCSC(tiles=tiles, specs=specs, m=m, n=n, nnz=A.nnz)


def tile_row_order(rows: np.ndarray, length: np.ndarray, m: int, transposed: bool = False) -> RowOrder:
    """Host ``RowOrder`` of one tile: the flat indices of its valid slots,
    stable-sorted by row, and the row pointer.  ``rows`` is (K, L), or (L, K)
    with ``transposed``."""
    rows = np.asarray(rows)
    L = rows.shape[0] if transposed else rows.shape[1]
    lane = np.arange(L)
    length = np.asarray(length)
    valid = (lane[:, None] < length[None, :]) if transposed else (lane[None, :] < length[:, None])
    slots = np.nonzero(valid.reshape(-1))[0]
    # a 16-bit key sorts by radix; the order is the same as for the wide key
    key_dt = np.uint16 if m <= np.iinfo(np.uint16).max else np.int32
    keys = rows.reshape(-1)[slots].astype(key_dt, copy=False)
    order = slots[np.argsort(keys, kind="stable")].astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=m))]).astype(np.int64)
    return RowOrder(order=order, ptr=ptr)


def device_put_blockcsc(bcsc: BlockCSC, device, row_orders: bool = False) -> BlockCSC:
    """Copy every tile array to ``device`` as a tensor (rows widened to int32).
    ``row_orders=True`` also builds each tile's ``RowOrder`` on the host and
    places it beside the tile."""

    def put(x, dtype=None):
        t = torch.as_tensor(np.ascontiguousarray(x), device=device)
        return t if dtype is None else t.to(dtype)

    orders = None
    if row_orders:
        orders = []
        for t in bcsc.tiles:
            ro = tile_row_order(t.rows, t.length, bcsc.m, bcsc.transposed)
            orders.append(RowOrder(order=put(ro.order), ptr=put(ro.ptr)))

    tiles = [
        Tile(
            rows=put(t.rows, torch.int32),
            a=put(t.a),
            c=put(t.c),
            length=put(t.length, torch.int32),
            col_ids=put(t.col_ids, torch.int32),
        )
        for t in bcsc.tiles
    ]
    return BlockCSC(
        tiles=tiles, specs=bcsc.specs, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz,
        transposed=bcsc.transposed, row_orders=orders,
    )


def blockcsc_from_numpy(tiles, specs, m: int, n: int, nnz: int, device, transposed: bool = False,
                        row_orders: bool = False) -> BlockCSC:
    """The port's BlockCSC from another builder's leaves as numpy arrays.

    ``tiles`` holds ``(rows, a, c, length, col_ids)`` per tile (the JAX
    package's ``Tile`` fields, e.g. its uint16 ``rows``, which are widened
    to int32); ``specs`` needs ``entry_key, proj_type, proj_params, K, L``
    and ``flat_idx``.  ``transposed`` says the arrays are (L, K);
    ``row_orders`` builds the segment-sum's row-sorted orders as well.
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
        device, row_orders=row_orders,
    )


def tile_valid_mask(tile: Tile, L: int) -> torch.Tensor:
    """(K, L) bool mask of real (non-padding) entries."""
    lane = torch.arange(L, device=tile.length.device, dtype=torch.int32)
    return lane[None, :] < tile.length[:, None]


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
