"""Objectives (``dualip_tpu/objectives``): the matching dual objective, with
its exact certificate, and the general-LP (MIPLIB-2017) dual objective."""

from dualip_tpu_torch.objectives.base import BaseInputArgs, BaseObjective  # noqa: F401
from dualip_tpu_torch.objectives.matching import (  # noqa: F401
    MatchingInputArgs,
    MatchingSolverDualObjectiveFunction,
    MatchingSolverDualObjectiveFunctionDistributed,
)
from dualip_tpu_torch.objectives.miplib import (  # noqa: F401
    MIPLIB2017ObjectiveFunction,
    MIPLIBInputArgs,
)
