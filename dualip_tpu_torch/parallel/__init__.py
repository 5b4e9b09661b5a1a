"""Parallelism layer: the 1-D entity mesh on ``torch.distributed``, its
launcher, and the split utilities (``dualip_tpu/parallel``).

The JAX package's shardings have no torch object; what stands in for each:

* ``entity_sharding`` (tiles split along the entity axis): each rank holds
  its own slice of the entity axis, the one the JAX package places on that
  device, and nothing of the other slices;
* ``replicated_sharding`` (the dual, ``b``): every rank holds its own whole
  copy, and the one ``all_reduce`` per evaluation keeps the copies
  bit-identical.
"""

from dualip_tpu_torch.parallel.mesh import (  # noqa: F401
    EntityMesh,
    default_mesh,
    initialize_multihost,
    is_rank_zero,
)
from dualip_tpu_torch.parallel.dist_utils import (  # noqa: F401
    global_to_local_projection_map,
    split_tensors_to_devices,
)
from dualip_tpu_torch.parallel.multihost import (  # noqa: F401
    assemble_global_tiles,
    local_matching_shard,
    process_shard_bounds,
)
from dualip_tpu_torch.parallel.launch import run_ranks  # noqa: F401
