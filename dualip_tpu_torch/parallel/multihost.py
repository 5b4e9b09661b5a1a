"""Per-rank input pipelines (``dualip_tpu/parallel/multihost.py``).

Each rank either generates its own contiguous entity shard (the same seed
gives the same global problem, sliced by rank) or loads it from its own
files, instead of one rank building everything and scattering it.
``assemble_global_tiles`` then gives a rank's tiles the global column ids and
sizes; the dual and ``b`` stay whole on every rank.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np

from dualip_tpu_torch.parallel.dist_utils import global_to_local_projection_map, split_tensors_to_devices
from dualip_tpu_torch.sparse.bcsc import BlockCSC, Tile, device_put_blockcsc


def _rank_and_world(process_index: Optional[int], process_count: Optional[int]) -> Tuple[int, int]:
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return pi, pc


def process_shard_bounds(
    num_cols: int, process_index: Optional[int] = None, process_count: Optional[int] = None
) -> Tuple[int, int]:
    """The balanced contiguous ``[start, end)`` column range of a rank (the
    split rule of ``split_tensors_to_devices``); rank and count default to the
    default process group's (0 and 1 without one)."""
    pi, pc = _rank_and_world(process_index, process_count)
    base, rem = divmod(num_cols, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)


def local_matching_shard(global_args, process_index: Optional[int] = None, process_count: Optional[int] = None):
    """The global matching problem sliced to a rank's contiguous entity range:
    its columns of A and c, its projection entries renumbered, ``b`` and the
    equality mask whole."""
    from dualip_tpu_torch.objectives.matching import MatchingInputArgs

    pi, pc = _rank_and_world(process_index, process_count)
    a_splits, c_splits, index_map = split_tensors_to_devices(global_args.A, global_args.c, list(range(pc)))
    return MatchingInputArgs(
        A=a_splits[pi],
        c=c_splits[pi],
        projection_map=global_to_local_projection_map(global_args.projection_map, index_map[pi]),
        b_vec=global_args.b_vec,
        equality_mask=global_args.equality_mask,
    )


def assemble_global_tiles(
    local_bcsc: BlockCSC,
    mesh,
    col_offset: Optional[int] = None,
    global_n: Optional[int] = None,
    global_nnz: Optional[int] = None,
) -> BlockCSC:
    """A rank's host tiles as its shard of the global tiles, on
    ``mesh.device``: ``col_ids`` offset to global ids by ``col_offset`` (by
    default the rank's ``process_shard_bounds(global_n)`` start when
    ``global_n`` is given), ``n``/``nnz`` the global ones where given, and
    the tiles' segment-sum plan beside them, so the result takes the place of
    a csc mesh objective's ``bcsc``.  The tiles stay rank-local (each rank's
    K is its own part of the entity axis).  ``spec.flat_idx`` indexes the
    local CSC, so it is dropped; scatter a primal back per rank on the local
    BlockCSC."""
    if col_offset is None and global_n is not None:
        col_offset = process_shard_bounds(global_n, mesh.rank, mesh.world_size)[0]
    tiles = []
    for t in local_bcsc.tiles:
        col_ids = np.asarray(t.col_ids)
        if col_offset:
            col_ids = np.where(col_ids >= 0, col_ids + int(col_offset), col_ids)
        tiles.append(Tile(rows=t.rows, a=t.a, c=t.c, length=t.length, col_ids=col_ids))
    host = BlockCSC(
        tiles=tiles,
        specs=[replace(s, flat_idx=None) for s in local_bcsc.specs],
        m=local_bcsc.m,
        n=global_n if global_n is not None else local_bcsc.n,
        nnz=global_nnz if global_nnz is not None else local_bcsc.nnz,
        transposed=local_bcsc.transposed,
        value_dtype=local_bcsc.value_dtype,
    )
    return device_put_blockcsc(host, mesh.device, row_sum=True)
