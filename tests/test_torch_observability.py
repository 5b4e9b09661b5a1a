"""The port's observability: MLflow logging as a silent no-op where mlflow is
missing or disabled, the store's spans (where the JAX package has
``PhaseTimer``), ``collect_stats`` and ``trace`` with a ``span`` (the cases of
``tests/test_misc_components.py``), on the CPU."""

import json

import numpy as np
import pytest
import torch

from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver
from dualip_tpu_torch.objectives.matching import MatchingInputArgs
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.types import ObjectiveResult
from dualip_tpu_torch.utils import mlflow_utils
from dualip_tpu_torch.utils.mlflow_utils import (
    MLflowConfig,
    is_mlflow_available,
    log_hyperparameters,
    log_metrics,
    log_objective_result,
    mlflow_run_context,
)
from dualip_tpu_torch.utils import profiling
from dualip_tpu_torch.utils.profiling import span, trace


def _args():
    a = np.array([[0.3, 0.5], [0.2, 0.8]], dtype=np.float32)
    return MatchingInputArgs(A=csc_from_dense(a), c=csc_from_dense(-a),
                             projection_map=create_projection_map("simplex", {"z": 1}, 2),
                             b_vec=np.array([0.7, 0.7], np.float32))


class _Quadratic:
    equality_mask = None

    def calculate(self, dual_val, save_primal=False, **kw):
        return ObjectiveResult(dual_gradient=-dual_val, dual_objective=-torch.sum(dual_val ** 2))


def test_mlflow_noop_when_disabled():
    with mlflow_run_context(MLflowConfig(enabled=False)) as run:
        assert run is None
        log_hyperparameters({"solver": {"max_iter": 10}})
        log_metrics({"dual_objective": 1.0}, step=1)
        log_objective_result(ObjectiveResult(dual_gradient=torch.zeros(2), dual_objective=torch.tensor(1.0)), step=1)
    assert not mlflow_utils._mlflow_state.is_enabled()


@pytest.fixture
def no_mlflow(monkeypatch):
    """mlflow missing, whatever this environment has installed."""
    import builtins

    real = builtins.__import__

    def hide(name, *a, **k):
        if name == "mlflow":
            raise ImportError("mlflow is hidden")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", hide)
    assert not is_mlflow_available()


@pytest.mark.parametrize("layout", ["csc", "butterfly"])
def test_solve_with_mlflow_enabled_completes(no_mlflow, layout):
    """enabled=True with mlflow missing runs the solve and logs nothing; the
    log equals the solve without a config."""
    kw = dict(input_args=_args(), solver_args=SolverArgs(max_iter=3, gamma=1e-3),
              compute_args=ComputeArgs(host_device="cpu"),
              objective_args=ObjectiveArgs(objective_type="matching", objective_kwargs={"layout": layout}))
    res = run_solver(**kw, mlflow_config=MLflowConfig(enabled=True))
    assert np.isfinite(res.dual_objective) and len(res.dual_objective_log) == 3
    assert res.dual_objective_log == run_solver(**kw).dual_objective_log
    assert not mlflow_utils._mlflow_state.is_enabled()  # the context reset the state


def test_agd_logs_each_iteration_when_enabled(monkeypatch):
    """With logging on (a fake mlflow state), every iteration's metrics and
    the final result reach the logging calls; off, none do."""
    calls = []
    import dualip_tpu_torch.optimizers.agd as agd_mod

    monkeypatch.setattr(agd_mod, "log_metrics", lambda m, step=None: calls.append(("m", step, m)))
    monkeypatch.setattr(agd_mod, "log_objective_result", lambda r, step=None: calls.append(("r", step)))
    AcceleratedGradientDescent(max_iter=4, gamma=1e-3).maximize(_Quadratic(), torch.ones(3))
    assert calls == []
    monkeypatch.setattr(mlflow_utils._mlflow_state, "is_enabled", lambda: True)
    res = AcceleratedGradientDescent(max_iter=4, gamma=1e-3).maximize(_Quadratic(), torch.ones(3))
    steps = [c[1] for c in calls if c[0] == "m"]
    assert steps == [1, 2, 3, 4]
    assert [c[2]["dual_objective"] for c in calls if c[0] == "m"] == pytest.approx(res.dual_objective_log)
    assert all(set(c[2]) == {"step_size", "dual_objective", "gamma"} for c in calls if c[0] == "m")
    assert [c[1] for c in calls if c[0] == "r"] == [1, 2, 3, 4, 4]  # each iteration, then the final result


def test_phase_timer(monkeypatch):
    """Phases add up in the store, per name, whether tracing is on or not
    when asked to (``always``)."""
    monkeypatch.setattr(profiling, "STORE", profiling.Store())
    with span("test.phase.a", always=True):
        pass
    with span("test.phase.a", always=True):
        pass
    agg = profiling.aggregate("test.phase.a")
    assert agg.count == 2 and agg.total_ns >= 0 and agg.self_ns == agg.total_ns


def test_collect_stats_populates_last_run_stats():
    solver = AcceleratedGradientDescent(max_iter=8, gamma=None)
    assert solver.last_run_stats is None
    solver.maximize(_Quadratic(), torch.ones(3))
    assert solver.last_run_stats is None  # off by default
    solver.collect_stats = True
    solver.maximize(_Quadratic(), torch.ones(3))
    stats = solver.last_run_stats
    assert stats is not None and stats["iters"] == 8
    assert stats["total_s"] > 0 and 0 <= stats["drain_s"] <= stats["total_s"]


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path / "t")):
        with span("dualip.solve"):
            run_solver(_args(), SolverArgs(max_iter=2, gamma=1e-3), ComputeArgs(host_device="cpu"),
                       ObjectiveArgs(objective_type="matching"))
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"dualip.solve", "dualip.agd.maximize", "dualip.agd.replay", "dualip.build"} <= names
    (spans,) = (tmp_path / "t").glob("spans_*.json")
    assert spans.name[len("spans_"):] == files[0].name[len("trace_"):]
    kept = json.loads(spans.read_text())
    assert {"dualip.solve", "dualip.agd.maximize"} <= {e["name"] for e in kept["events"]}
    assert kept["aggregates"]["dualip.agd.maximize"]["count"] >= 1
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
