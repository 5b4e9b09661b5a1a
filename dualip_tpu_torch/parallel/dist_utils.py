"""Entity-sharding utilities (``dualip_tpu/parallel/dist_utils.py``).

For pipelines that split the problem per rank before building anything
(per-rank loading).  A sharded solve needs neither: every rank hands the whole
problem to ``MatchingSolverDualObjectiveFunction(..., mesh=...)`` and keeps its
own shard of the tiles.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse.csc import CSCMatrix, split_csc_by_cols


def global_to_local_projection_map(
    global_map: Dict[str, ProjectionEntry], local_cols: Sequence[int]
) -> Dict[str, ProjectionEntry]:
    """Each entry's columns renumbered to the shard's local ones; entries
    with no column in the shard are dropped."""
    global2local = {g: loc for loc, g in enumerate(local_cols)}
    local_map: Dict[str, ProjectionEntry] = {}
    for key, entry in global_map.items():
        local_indices = [global2local[g] for g in entry.indices if g in global2local]
        if local_indices:
            local_map[key] = ProjectionEntry(
                proj_type=entry.proj_type, proj_params=entry.proj_params, indices=local_indices)
    return local_map


def split_tensors_to_devices(
    a_mat: CSCMatrix, c_mat: CSCMatrix, compute_devices: Sequence
) -> Tuple[List[CSCMatrix], List[CSCMatrix], List[List[int]]]:
    """A balanced contiguous column split of (A, c), one part per entry of
    ``compute_devices`` (only their count matters; the parts stay on the host)
    and each part's global column ids.  The first ``n % parts`` parts take
    one column more."""
    num_cols = a_mat.shape[1]
    if not compute_devices:
        return [a_mat], [c_mat], [list(range(num_cols))]
    parts = len(compute_devices)
    base, rem = divmod(num_cols, parts)
    split_sizes = [base + (1 if i < rem else 0) for i in range(parts)]
    split_index_map, start = [], 0
    for size in split_sizes:
        split_index_map.append(list(range(start, start + size)))
        start += size
    return split_csc_by_cols(a_mat, split_sizes), split_csc_by_cols(c_mat, split_sizes), split_index_map
