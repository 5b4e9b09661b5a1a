"""Objectives (``dualip_tpu/objectives``): the matching dual objective."""

from dualip_tpu_torch.objectives.base import BaseInputArgs, BaseObjective  # noqa: F401
from dualip_tpu_torch.objectives.matching import (  # noqa: F401
    MatchingInputArgs,
    MatchingSolverDualObjectiveFunction,
)
