"""Streaming host build of a sharded solve's tile-cache entry
(``dualip_tpu/io/streaming_build.py``).

Building the whole problem's BlockCSC and row layout before anything reaches
the disk holds every tile in host memory at once.  This builds the stacked
butterfly entry (``io/tile_cache.py``) one shard at a time, straight from the
generator's memmap cache (``ccol/rows/a/c/b .npy``), so the host holds one
shard's tiles and routing at a time:

* pass 0 (O(n + m S) memory): column degrees from ``ccol``; shards are
  contiguous column ranges; the forced shapes every shard takes (each tile's
  column count and L maxed over shards, then the row buckets and N, as
  ``sparse/rowmajor.py::build_row_layout_sharded`` forces them);
* pass 1 (per shard): slice the mapped CSC, fill the shard's tiles, route its
  Benes plan (the port's native router where it builds), and write every leaf
  into the shard's slice of the stacked ``.npy`` files.

The entry has the JAX package's bytes for the same inputs, and a mesh solve
warm-starts from it.  Its shards are contiguous column ranges, not the
per-tile K slices of ``build_row_layout_sharded``: both are layouts of the
same problem whose sums group differently.  Host-only: numpy and torch on
the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse.csc import CSCMatrix


def _chunked_diff_lengths(ccol: np.ndarray, chunk: int = 1 << 24) -> np.ndarray:
    n = ccol.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = (ccol[lo + 1 : hi + 1] - ccol[lo:hi]).astype(np.int32)
    return out


def _chunked_row_counts(rows: np.ndarray, lo: int, hi: int, m: int, chunk: int = 1 << 25) -> np.ndarray:
    counts = np.zeros(m, dtype=np.int64)
    for s in range(lo, hi, chunk):
        e = min(s + chunk, hi)
        counts += np.bincount(np.asarray(rows[s:e], dtype=np.int64), minlength=m)
    return counts


def stream_build_sharded_cache(
    mm_dir,
    shape,
    projection_map: Dict[str, ProjectionEntry],
    n_shards: int,
    cache_dir,
    key: str,
    plan_cache_dir,
    dtype=np.float32,
    compact: bool = True,
    pad_cols_to: int = 1024,
    progress=None,
) -> Optional[Path]:
    """Build and publish the stacked entry ``butterfly_<key>`` from the
    generator's memmap directory; returns its path (at once on a hit).

    ``projection_map`` must partition the columns as the objective would (the
    matching workload: one simplex entry over all sources).  The memmap's
    ``c`` is the generator's raw reward and is negated here, as
    ``synthetic.py`` does.  ``plan_cache_dir`` is required: the entry names
    one plan file per shard."""
    from dualip_tpu_torch.io import tile_cache
    from dualip_tpu_torch.sparse.bcsc import (
        BlockCSC,
        Tile,
        TileSpec,
        _build_tile,
        _exact_thresholds,
        _pow2_thresholds,
        is_bfloat16,
    )
    from dualip_tpu_torch.sparse.rowmajor import _col_geometry, _forced_shapes, build_row_layout

    log = progress or (lambda s: None)
    mm_dir = Path(mm_dir)
    d = Path(cache_dir) / f"butterfly_{key}"
    if (d / "meta.json").exists():
        return d
    tmp = tile_cache._fresh_tmp(d)

    ccol = np.load(mm_dir / "ccol.npy", mmap_mode="r")
    rows_mm = np.load(mm_dir / "rows.npy", mmap_mode="r")
    a_mm = np.load(mm_dir / "a.npy", mmap_mode="r")
    c_mm = np.load(mm_dir / "c.npy", mmap_mode="r")
    m, n = int(shape[0]), int(shape[1])
    nnz = int(rows_mm.shape[0])
    if ccol.shape[0] != n + 1:
        raise ValueError(f"ccol has {ccol.shape[0]} entries, expected n+1={n + 1}")

    # ---- pass 0: global statistics and the forced shapes
    log("pass0: column degrees")
    lengths = _chunked_diff_lengths(np.asarray(ccol))
    col_thresholds = _exact_thresholds(lengths) if compact else _pow2_thresholds(m)
    bucket_of_col = np.searchsorted(col_thresholds, lengths, side="left")
    n_loc = -(-n // n_shards)
    shard_ranges = [(s * n_loc, min((s + 1) * n_loc, n)) for s in range(n_shards)]

    entries = list(projection_map.items())
    entry_of_col = np.full(n, -1, dtype=np.int32)
    for ei, (ekey, entry) in enumerate(entries):
        idx = np.asarray(entry.indices, dtype=np.int64)
        if (entry_of_col[idx] >= 0).any():
            raise ValueError(f"Projection entry '{ekey}' overlaps another entry")
        entry_of_col[idx] = ei
    if (entry_of_col < 0)[lengths > 0].any():
        entries.append(("__identity__", ProjectionEntry("identity", {}, [])))
        entry_of_col[(entry_of_col < 0) & (lengths > 0)] = len(entries) - 1

    forced_K: Dict[tuple, int] = {}  # (entry, bucket) -> columns, maxed over shards
    bucket_L: Dict[tuple, int] = {}
    for lo, hi in shard_ranges:
        le, eo = lengths[lo:hi], entry_of_col[lo:hi]
        valid = le > 0
        for ei in range(len(entries)):
            sel = valid & (eo == ei)
            if not sel.any():
                continue
            bids = bucket_of_col[lo:hi][sel]
            for b in np.unique(bids):
                tk = (ei, int(b))
                forced_K[tk] = max(forced_K.get(tk, 0), int((bids == b).sum()))
                bucket_L[tk] = max(bucket_L.get(tk, 0), int(le[sel][bids == b].max()))
    tile_keys = sorted(forced_K)
    for tk in tile_keys:
        forced_K[tk] = -(-forced_K[tk] // pad_cols_to) * pad_cols_to

    log("pass0: per-shard row histograms")
    per_shard_counts = [_chunked_row_counts(rows_mm, int(ccol[lo]), int(ccol[hi]), m) for lo, hi in shard_ranges]
    col_total = 0
    for tk in tile_keys:
        L2, _, BP = _col_geometry(forced_K[tk], bucket_L[tk], compact)
        col_total += BP * L2 * 128
    forced = _forced_shapes(per_shard_counts, col_total, compact)
    del per_shard_counts
    log(f"pass0 done: {len(tile_keys)} tiles, col_total={col_total}, N={forced['N']}")

    # ---- pass 1: each shard built and written into its slice of the stacked files
    bf16 = is_bfloat16(dtype)
    c_dtype = np.float32 if bf16 else dtype
    created = set()
    plan_files, meta = [], None
    for s, (lo, hi) in enumerate(shard_ranges):
        log(f"shard {s}/{n_shards}: columns [{lo}, {hi})")
        c0, c1 = int(ccol[lo]), int(ccol[hi])
        indptr_s = (np.asarray(ccol[lo : hi + 1]) - c0).astype(np.int64)
        A_s = CSCMatrix(indptr=indptr_s, row_indices=rows_mm[c0:c1], data=a_mm[c0:c1], shape=(m, hi - lo))
        C_s = CSCMatrix(indptr=indptr_s, row_indices=A_s.row_indices,
                        data=-np.asarray(c_mm[c0:c1], dtype=c_dtype), shape=(m, hi - lo))
        le, eo, bid = lengths[lo:hi], entry_of_col[lo:hi], bucket_of_col[lo:hi]
        tiles, specs = [], []
        for ei, b in tile_keys:
            cols = np.nonzero((eo == ei) & (bid == b) & (le > 0))[0]
            ekey, entry = entries[ei]
            K_f, L_f = forced_K[(ei, b)], bucket_L[(ei, b)]
            params = tuple(sorted(dict(entry.proj_params).items()))
            if cols.size == 0:  # no column of this shard in the bucket: a tile of padding
                z = np.zeros((K_f, L_f), np.float32 if bf16 else dtype)
                t = Tile(rows=np.zeros((K_f, L_f), np.int32), a=z, c=z.copy(), length=np.zeros(K_f, np.int32),
                         col_ids=np.full(K_f, -1, np.int32))
                sp = TileSpec(entry_key=ekey, proj_type=entry.proj_type, proj_params=params, K=K_f, L=L_f)
            else:
                t, sp = _build_tile(A_s, C_s, cols, ekey, entry.proj_type, dict(entry.proj_params),
                                    pad_cols_to=K_f, keep_flat_idx=False, dtype=dtype)
                if t.a.shape[0] != K_f:
                    raise AssertionError(f"tile K {t.a.shape[0]} != forced {K_f}")
                if sp.L != L_f:  # lanes padded to the bucket's L over all shards
                    widen = ((0, 0), (0, L_f - sp.L))
                    t = t._replace(rows=np.pad(t.rows, widen), a=np.pad(t.a, widen), c=np.pad(t.c, widen))
                    sp = TileSpec(entry_key=sp.entry_key, proj_type=sp.proj_type, proj_params=sp.proj_params,
                                  K=sp.K, L=L_f)
            tiles.append(t)
            specs.append(sp)
        shard = BlockCSC(tiles=tiles, specs=specs, m=m, n=n, nnz=nnz, value_dtype=torch.bfloat16 if bf16 else None)
        rl = build_row_layout(shard, method="butterfly", plan_cache_dir=plan_cache_dir, compact=compact,
                              _forced=forced, materialize_plan=False)
        plan_files.append(rl.plan_cache_path)
        if meta is None:
            meta = tile_cache._meta(shard, rl, n_shards, plan_files)
        for name, (arr, as_bf16) in tile_cache._leaves(shard, rl).items():
            path = tmp / f"{name}.npy"
            if name not in created:
                tile_cache._create_stacked(path, (n_shards,) + arr.shape, arr.dtype, as_bf16)
                created.add(name)
            tile_cache._write_slice(path, s, arr)
        del tiles, specs, shard, rl, A_s, C_s

    if any(p is None for p in plan_files):
        raise ValueError("plan_cache_dir must be set (the entry names each shard's Benes plan file)")
    # the JAX package's key order for a streamed entry
    out = {k: meta[k] for k in ("version", "m", "n", "nnz", "n_shards")}
    out["plan_cache_file"] = [str(p) for p in plan_files]
    out["specs"] = meta["specs"]
    out.update({k: meta[k] for k in ("col_offsets", "row_shapes", "col_pack")})
    tile_cache._publish(tmp, d, out)
    return d
