"""Maximizers (``dualip_tpu/optimizers``)."""

from dualip_tpu_torch.optimizers.agd import (  # noqa: F401
    AcceleratedGradientDescent,
    compute_beta_seq,
    format_objective_result_summary,
    project_on_nn_cone,
)
from dualip_tpu_torch.optimizers.agd_utils import (  # noqa: F401
    StepSizeState,
    calculate_step_size,
    init_step_size_state,
)
