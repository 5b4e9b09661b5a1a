"""Projection operator registry (``dualip_tpu/projections``).

Importing this package registers ``box``, ``cone``, ``simplex``,
``simplex_eq``, ``box_cut``, ``box_cut_eq`` and ``identity``.
"""

from dualip_tpu_torch.projections.base import (  # noqa: F401
    ProjectionEntry,
    ProjectionOperator,
    create_projection_map,
    project,
    register,
    registered_projections,
)

from dualip_tpu_torch.projections import box as _box  # noqa: F401,E402
from dualip_tpu_torch.projections import box_cut as _box_cut  # noqa: F401,E402
from dualip_tpu_torch.projections import cone as _cone  # noqa: F401,E402
from dualip_tpu_torch.projections import simplex as _simplex  # noqa: F401,E402

from dualip_tpu_torch.projections.box_cut import box_cut_project  # noqa: F401,E402
from dualip_tpu_torch.projections.simplex import bisection_project, duchi_project  # noqa: F401,E402

__all__ = [
    "project",
    "ProjectionOperator",
    "create_projection_map",
    "ProjectionEntry",
    "register",
    "registered_projections",
    "duchi_project",
    "bisection_project",
    "box_cut_project",
]
