"""MLflow logging (``dualip_tpu/utils/mlflow_utils.py``).

``MLflowConfig``, ``mlflow_run_context``, ``log_hyperparameters`` (the
selected solver and objective parameters), ``log_metrics`` and
``log_objective_result``.  Every call is a silent no-op when MLflow is not
installed or logging is disabled, and a logging error is printed and
swallowed, so logging never stops a solve.  ``mlflow`` is imported only
inside ``is_mlflow_available`` and the calls it allows.

The AGD maximizer feeds the per-iteration metrics from its chunked metric
fetches; with logging off its loop does no extra work.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional, Set, Union

import numpy as np
import torch


def _host(value):
    """A tensor (on any device) as a numpy array; anything else as it is."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value


def is_mlflow_available() -> bool:
    try:
        import mlflow  # noqa: F401

        return True
    except ImportError:
        return False


@dataclass
class MLflowConfig:
    """What to log and where."""

    enabled: bool
    tracking_uri: str = ""
    experiment_name: str = ""
    run_name: str = ""
    log_hyperparameters: bool = True
    log_metrics: bool = True
    synchronous: bool = False


class MLflowState:
    """Process-global logging state: the active config and run."""

    def __init__(self):
        self.config: Optional[MLflowConfig] = None
        self.active_run = None
        self._enabled = False

    def set_config(self, config: MLflowConfig):
        self.config = config
        self._enabled = config.enabled and is_mlflow_available()

    def is_enabled(self) -> bool:
        return self._enabled and self.config is not None

    def set_active_run(self, run):
        self.active_run = run


_mlflow_state = MLflowState()


@contextmanager
def mlflow_run_context(config: MLflowConfig):
    """Set up an MLflow experiment and run; a no-op when disabled or
    unavailable."""
    _mlflow_state.set_config(config)

    if not config.enabled or not is_mlflow_available():
        yield None
        return

    import mlflow

    try:
        if config.tracking_uri:
            mlflow.set_tracking_uri(config.tracking_uri)
        experiment_name = config.experiment_name or "dualip_experiments"
        experiment = mlflow.set_experiment(experiment_name)
        run_name = config.run_name or "dualip_run"
        with mlflow.start_run(run_name=run_name, experiment_id=experiment.experiment_id) as run:
            _mlflow_state.set_active_run(run)
            yield run
    except Exception as e:  # noqa: BLE001 - logging must never crash a solve
        print(f"MLflow logging failed: {e}. Continuing without MLflow logging.")
        yield None
    finally:
        _mlflow_state.set_config(MLflowConfig(enabled=False))
        _mlflow_state.set_active_run(None)


def _log_single_param(key: str, value: Any) -> None:
    import mlflow

    try:
        if isinstance(value, (int, float, str, bool)):
            mlflow.log_param(key, value)
        elif hasattr(value, "size") and np.asarray(_host(value)).size == 1:
            mlflow.log_param(key, np.asarray(_host(value)).item())
        else:
            mlflow.log_param(key, str(value))
    except Exception as e:  # noqa: BLE001
        print(f"Failed to log parameter {key}: {e}")


_SOLVER_PARAMS_TO_LOG: Set[str] = {"max_iter", "initial_step_size", "max_step_size", "gamma", "gamma_decay_type"}
_OBJECTIVE_PARAMS_TO_LOG: Set[str] = {"objective_type"}


def log_hyperparameters(params: Dict[str, Any], step: Optional[int] = None) -> None:
    """Log the selected solver and objective hyperparameters."""
    del step
    if not _mlflow_state.is_enabled():
        return
    if not _mlflow_state.config.log_hyperparameters:
        return
    try:
        for key, value in params.items():
            if key == "solver":
                for k, v in value.items():
                    if k in _SOLVER_PARAMS_TO_LOG:
                        _log_single_param(f"solver.{k}", v)
            elif key == "objective":
                for k, v in value.items():
                    if k in _OBJECTIVE_PARAMS_TO_LOG:
                        _log_single_param(f"objective.{k}", v)
    except Exception as e:  # noqa: BLE001
        print(f"Failed to log hyperparameters: {e}")


def log_metrics(metrics: Dict[str, Union[float, int]], step: Optional[int] = None) -> None:
    """Log scalar metrics (size-one arrays and tensors included)."""
    if not _mlflow_state.is_enabled():
        return
    if not _mlflow_state.config.log_metrics:
        return
    import mlflow

    try:
        for key, value in metrics.items():
            if isinstance(value, (int, float, bool)):
                kwargs = {"step": step} if step is not None else {}
                mlflow.log_metric(key, value, synchronous=_mlflow_state.config.synchronous, **kwargs)
            else:
                arr = np.asarray(_host(value))
                if arr.size == 1:
                    kwargs = {"step": step} if step is not None else {}
                    mlflow.log_metric(key, float(arr), synchronous=_mlflow_state.config.synchronous, **kwargs)
    except Exception as e:  # noqa: BLE001
        print(f"Failed to log metrics: {e}")


def log_objective_result(result, step: Optional[int] = None) -> None:
    """Log an ObjectiveResult's scalar fields as metrics."""
    if not _mlflow_state.is_enabled():
        return
    try:
        metrics = {}
        for name, field in (
            ("dual_objective", result.dual_objective),
            ("primal_objective", result.primal_objective),
            ("regularization_penalty", result.reg_penalty),
            ("max_positive_slack", result.max_pos_slack),
            ("sum_positive_slack", result.sum_pos_slack),
        ):
            if field is not None:
                metrics[name] = float(np.asarray(_host(field)))
        if metrics:
            log_metrics(metrics, step)
    except Exception as e:  # noqa: BLE001
        print(f"Failed to log objective result: {e}")
