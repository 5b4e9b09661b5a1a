"""dualip_tpu_torch: the PyTorch/CUDA port of ``dualip_tpu``.

Ridge-regularized dual ascent for structured LPs, with the same public API
as the JAX package; tensors live on ``cuda`` unless the caller asks for the
CPU, and the hot path runs hand-written Hopper kernels (``csrc/``).
"""

__version__ = "0.1.0"

from dualip_tpu_torch.types import (  # noqa: F401
    ComputeArgs,
    ObjectiveArgs,
    ObjectiveResult,
    SolverArgs,
    SolverResult,
)

from dualip_tpu_torch.run_solver import (  # noqa: F401,E402
    build_objective,
    register_objective,
    run_solver,
    transfer_tensors_to_device,
)
