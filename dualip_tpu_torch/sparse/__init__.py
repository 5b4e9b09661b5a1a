"""Sparse containers: host flat CSC (ingestion) and BlockCSC tiles."""

from dualip_tpu_torch.sparse.csc import (  # noqa: F401
    CSCMatrix,
    csc_col_ids,
    csc_from_arrays,
    csc_from_dense,
    same_pattern,
)
from dualip_tpu_torch.sparse.bcsc import (  # noqa: F401
    BlockCSC,
    Tile,
    TileSpec,
    blockcsc_from_numpy,
    build_blockcsc,
    device_put_blockcsc,
    tile_valid_mask,
    tiles_values_to_flat,
)
