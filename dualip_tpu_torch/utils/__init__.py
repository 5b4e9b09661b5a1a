"""Observability: MLflow logging (a no-op without mlflow) and profiling hooks."""

from dualip_tpu_torch.utils.mlflow_utils import (  # noqa: F401
    MLflowConfig,
    is_mlflow_available,
    log_hyperparameters,
    log_metrics,
    log_objective_result,
    mlflow_run_context,
)
from dualip_tpu_torch.utils.profiling import PhaseTimer, annotate, trace  # noqa: F401
