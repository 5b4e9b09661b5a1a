"""Sparse containers: host flat CSC (ingestion) and BlockCSC tiles."""

from dualip_tpu_torch.sparse.csc import (  # noqa: F401
    CSCMatrix,
    csc_col_ids,
    csc_from_arrays,
    csc_from_dense,
    csc_from_scipy,
    csc_matvec,
    csc_rmatvec,
    csc_to_dense,
    dot_product_csc,
    elementwise_csc,
    hstack_csc,
    left_multiply_sparse,
    right_multiply_sparse,
    row_norms_csc,
    row_sums_csc,
    same_pattern,
    split_csc_by_cols,
    vstack_csc,
)
from dualip_tpu_torch.sparse.bcsc import (  # noqa: F401
    BlockCSC,
    Tile,
    apply_projections,
    flat_to_tiles_values,
    TileSpec,
    blockcsc_from_numpy,
    build_blockcsc,
    device_put_blockcsc,
    tile_valid_mask,
    tiles_values_to_flat,
)
