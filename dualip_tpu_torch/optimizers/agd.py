"""Nesterov accelerated gradient ascent (``dualip_tpu/optimizers/agd.py``).

FISTA beta sequence, the Lipschitz-window step size, projection of the duals
onto the nonnegative cone with equality rows left free, gamma step decay,
optional adaptive restart, and per-iteration dual-objective and step-size
logs.

Where the JAX package compiles the solve into one ``lax.scan``, this is an
eager Python loop that queues each iteration's kernels on the device and
never waits for them: the per-iteration metrics go into a preallocated
``(max_iter, 8)`` device tensor that is fetched once at the end.  Only an
``iteration_callback``, MLflow logging or a ``stop_condition`` makes the loop
wait for the device, at the iterations where it runs.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from dualip_tpu_torch.optimizers.agd_utils import (
    DEFAULT_HISTORY_LENGTH,
    StepSizeState,
    calculate_step_size,
    init_step_size_state,
)
from dualip_tpu_torch.parallel.mesh import is_rank_zero
from dualip_tpu_torch.types import ObjectiveResult, SolverResult, resolve_device
from dualip_tpu_torch.utils.mlflow_utils import _mlflow_state, log_metrics, log_objective_result

# Columns of the per-iteration metrics tensor (``dualip_tpu`` ``_Metrics``).
METRICS = (
    "dual_objective",
    "step_size",
    "grad_norm",
    "gamma",
    "reg_penalty",
    "dual_val_times_grad",
    "max_pos_slack",
    "sum_pos_slack",
)
_OPTIONAL = METRICS[4:]


def project_on_nn_cone(y: torch.Tensor, equality_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project duals onto the nonnegative cone; equality rows stay free."""
    projected = torch.clamp_min(y, 0.0)
    if equality_mask is not None:
        return torch.where(equality_mask, y, projected)
    return projected


def compute_beta_seq(max_iter: int) -> np.ndarray:
    """FISTA momentum ``beta_i = (1 - t_{i+1}) / t_{i+2}`` with
    ``t_{i+1} = (1 + sqrt(1 + 4 t_i^2)) / 2``, stored in float32 with a
    float64 sqrt, as the golden traces need."""
    t = np.zeros(max_iter + 2, dtype=np.float32)
    for i in range(1, max_iter + 2):
        t[i] = np.float32((1.0 + math.sqrt(1.0 + 4.0 * float(np.float32(t[i - 1]) ** 2))) / 2.0)
    beta = np.zeros(max_iter, dtype=np.float32)
    for i in range(max_iter):
        beta[i] = (np.float32(1.0) - t[i + 1]) / t[i + 2]
    return beta


def format_objective_result_summary(iteration: int, objective_result: ObjectiveResult) -> str:
    """One-line per-iteration summary."""

    def _fmt(name, val):
        if val is None:
            return None
        arr = np.asarray(val.detach().cpu() if isinstance(val, torch.Tensor) else val)
        if np.issubdtype(arr.dtype, np.floating) and arr.size == 1 and np.isnan(arr):
            return None
        if arr.size == 1:
            return f"{name}={arr.item()}"
        return f"{name}.shape={tuple(arr.shape)}"

    grad_norm_str = None
    if objective_result.dual_gradient is not None:
        grad_norm = float(torch.linalg.vector_norm(torch.as_tensor(objective_result.dual_gradient)))
        grad_norm_str = f"dual_grad_norm={grad_norm}"

    parts = [
        f"iter={iteration}",
        _fmt("dual_objective", objective_result.dual_objective),
        grad_norm_str,
        _fmt("reg_penalty", objective_result.reg_penalty),
        _fmt("primal_objective", objective_result.primal_objective),
        _fmt("primal_var", objective_result.primal_var),
        _fmt("dual_val_times_grad", objective_result.dual_val_times_grad),
        _fmt("max_pos_slack", objective_result.max_pos_slack),
        _fmt("sum_pos_slack", objective_result.sum_pos_slack),
    ]
    return " | ".join(p for p in parts if p is not None)


class AcceleratedGradientDescent:
    """Maximizes a dual objective with Nesterov-accelerated ascent.

    Same constructor as ``dualip_tpu``'s.  ``callback_chunk``: with an
    iteration callback or MLflow logging, the loop fetches metrics every
    ``callback_chunk`` iterations and calls the callback (and logs) once per
    iteration.  ``launch_chunk`` is accepted for parity and has no effect: the
    eager loop has no single launch to cut.

    On a mesh (a sharded objective) every rank runs this loop on the same
    bits and only rank 0 logs to MLflow.

    ``collect_stats = True`` records the next ``maximize``'s wall clock in
    ``last_run_stats``: ``total_s`` (the whole call up to the metrics fetch),
    ``iters`` (``max_iter``) and ``drain_s`` (the fetch, which waits for the
    device to finish the queued iterations).
    """

    def __init__(
        self,
        max_iter: int,
        gamma: Optional[float],
        initial_step_size: float = 1e-5,
        max_step_size: float = 0.1,
        gamma_decay_type: Optional[str] = None,
        gamma_decay_params: Optional[dict] = None,
        save_primal: bool = False,
        iteration_callback: Optional[Callable[[int, ObjectiveResult], None]] = None,
        history_length: int = DEFAULT_HISTORY_LENGTH,
        callback_chunk: int = 1,
        verbose: bool = False,
        stop_condition: Optional[Callable[[int, torch.Tensor], bool]] = None,
        stop_check_every: int = 0,
        restart: Optional[str] = None,
        restart_min_spacing: int = 50,
        launch_chunk: int = 0,
    ):
        if gamma_decay_type not in (None, "step"):
            raise ValueError(f"Unsupported gamma decay type: {gamma_decay_type}")
        if restart not in (None, "gradient", "function"):
            raise ValueError(f"Unsupported restart scheme: {restart!r}")
        del launch_chunk
        self.max_iter = max_iter
        self.gamma = gamma
        self.initial_step_size = float(initial_step_size)
        self.max_step_size = float(max_step_size)
        self.gamma_decay_type = gamma_decay_type
        self.gamma_decay_params = gamma_decay_params or {}
        self.save_primal = save_primal
        self.history_length = history_length
        self.callback_chunk = max(1, int(callback_chunk))
        self.beta_seq = compute_beta_seq(max_iter)
        self.iteration_callback = iteration_callback
        if iteration_callback is None and verbose:
            self.iteration_callback = self._default_iteration_callback
        self.stop_condition = stop_condition
        self.stop_check_every = int(stop_check_every)
        if stop_condition is not None and self.stop_check_every <= 0:
            self.stop_check_every = 100
        self.restart = restart
        self.restart_min_spacing = int(restart_min_spacing)
        self.collect_stats = False
        self.last_run_stats = None

    @staticmethod
    def _default_iteration_callback(iteration: int, objective_result: ObjectiveResult) -> None:
        print(format_objective_result_summary(iteration, objective_result))

    def _calc(self, f, params, dual_val: torch.Tensor, gamma: torch.Tensor) -> ObjectiveResult:
        """The objective at ``dual_val``; gamma is passed only when configured."""
        g = gamma if self.gamma is not None else None
        if hasattr(f, "calculate_traceable"):
            return f.calculate_traceable(params, dual_val, g)
        kwargs = {"gamma": g} if self.gamma is not None else {}
        return f.calculate(dual_val=dual_val, **kwargs)

    def maximize(
        self,
        f,
        initial_value,
        rank: int = 0,
        initial_step_size_state: Optional[StepSizeState] = None,
    ) -> SolverResult:
        """Run ``max_iter`` ascent iterations (fewer if ``stop_condition``
        fires).  ``f`` exposes ``equality_mask``, ``params`` and
        ``calculate_traceable(params, dual_val, gamma)``, or just
        ``calculate(dual_val, ...)``.  ``initial_value`` and the step-size
        window may be tensors or numpy arrays; numpy ones go to ``f.device``
        (``cuda`` when ``f`` names none), a float64 one as float32.
        """
        t_start = time.perf_counter()
        if isinstance(initial_value, torch.Tensor):
            x0 = initial_value
        else:  # numpy float64 solves in float32, as in the JAX package (x64 off)
            x0 = np.asarray(initial_value)
            x0 = torch.as_tensor(x0.astype(np.float32) if x0.dtype == np.float64 else x0,
                                 device=resolve_device(getattr(f, "device", None)))
        dev = x0.device
        dtype, m = x0.dtype, x0.shape[0]
        equality_mask = getattr(f, "equality_mask", None)
        if equality_mask is not None:
            equality_mask = torch.as_tensor(equality_mask, dtype=torch.bool, device=dev)
        params = getattr(f, "params", ())

        def full(v, dt=dtype):
            return torch.full((), v, dtype=dt, device=dev)

        if initial_step_size_state is None:
            ss = init_step_size_state(m, self.history_length, dtype, dev)
        else:
            ss = StepSizeState(
                grad_hist=torch.as_tensor(initial_step_size_state.grad_hist, dtype=dtype, device=dev),
                dual_hist=torch.as_tensor(initial_step_size_state.dual_hist, dtype=dtype, device=dev),
                count=int(initial_step_size_state.count),
            )
        gamma = full(self.gamma if self.gamma is not None else math.nan, torch.float32)
        max_step = full(self.max_step_size, torch.float32)
        beta_all = torch.as_tensor(self.beta_seq, device=dev)
        nan = full(math.nan)
        metrics = torch.full((self.max_iter, len(METRICS)), math.nan, dtype=dtype, device=dev)
        fields_present = {}

        decay = self.gamma_decay_type == "step"
        if decay:
            decay_steps = int(self.gamma_decay_params["decay_steps"])
            decay_factor = float(self.gamma_decay_params["decay_factor"])
        restart = self.restart
        beta_idx = torch.zeros(1, dtype=torch.long, device=dev)
        prev_obj = full(-math.inf)

        x = y = last_x = x0
        last_grad = torch.zeros(m, dtype=dtype, device=dev)
        logging = _mlflow_state.is_enabled() and is_rank_zero()
        observing = self.iteration_callback is not None or logging
        fetched = 0
        done = 0
        for i in range(self.max_iter):
            it_num = i + 1
            res = self._calc(f, params, x, gamma)
            grad = res.dual_gradient
            obj = torch.as_tensor(res.dual_objective, device=dev).to(dtype)
            step, ss = calculate_step_size(grad, y, ss, self.initial_step_size, max_step)
            y_new = project_on_nn_cone(x + grad * step, equality_mask)
            beta = beta_all[i]
            if restart is not None:
                if restart == "gradient":
                    bad = torch.dot(grad, y_new - y) < 0
                else:  # "function": the dual objective went down
                    bad = obj < prev_obj
                bad = bad & (beta_idx[0] >= self.restart_min_spacing)
                beta = torch.where(bad, full(0.0, beta_all.dtype), beta_all.index_select(0, beta_idx)[0])
                beta_idx = torch.where(bad, torch.ones_like(beta_idx), beta_idx + 1)
                prev_obj = obj
            x_new = y_new * (1.0 - beta) + y * beta
            if decay and it_num % decay_steps == 0:
                gamma = gamma * decay_factor
                max_step = step * decay_factor
                if restart == "function":  # the decay, not oscillation, lowers g_gamma
                    prev_obj = full(-math.inf)

            row = [obj, step.to(dtype), torch.linalg.vector_norm(grad).to(dtype), gamma.to(dtype)]
            for name in _OPTIONAL:
                val = getattr(res, name)
                fields_present[name] = val is not None
                row.append(nan if val is None else torch.as_tensor(val, device=dev).to(dtype))
            metrics[i] = torch.stack(row)
            last_x, last_grad = x, grad
            x, y = x_new, y_new
            done = it_num

            if observing and (it_num - fetched >= self.callback_chunk or it_num == self.max_iter):
                rows = metrics[fetched:it_num].cpu().numpy()
                for k, r in enumerate(rows):
                    per_iter = self._row_to_result(r, fields_present)
                    if self.iteration_callback is not None:
                        self.iteration_callback(fetched + k + 1, per_iter)
                    if logging:
                        self._log_row(fetched + k + 1, r, per_iter)
                fetched = it_num
            if self.stop_condition is not None and (
                it_num % self.stop_check_every == 0 or it_num == self.max_iter
            ):
                if self.stop_condition(it_num, y):
                    break

        t_drain = time.perf_counter()
        host = metrics[:done].cpu().numpy()  # the one fetch of the solve's metrics
        if self.collect_stats:
            now = time.perf_counter()
            self.last_run_stats = {"total_s": now - t_start, "iters": self.max_iter, "drain_s": now - t_drain}
        dual_obj_log: List[float] = host[:, 0].tolist()
        step_size_log: List[float] = host[:, 1].tolist()
        dual_obj = dual_obj_log[-1]
        last = self._row_to_result(host[-1], fields_present)
        final_res = ObjectiveResult(
            dual_gradient=last_grad,
            dual_objective=np.float32(dual_obj),
            reg_penalty=last.reg_penalty,
            dual_val_times_grad=last.dual_val_times_grad,
            max_pos_slack=last.max_pos_slack,
            sum_pos_slack=last.sum_pos_slack,
        )
        if self.save_primal:
            # One more evaluation at the last iteration's x, with only the
            # kwargs a (possibly duck-typed) objective accepts.
            kwargs = {}
            if self.gamma is not None:
                kwargs["gamma"] = gamma
            try:
                accepted = inspect.signature(f.calculate).parameters
                if "save_primal" in accepted:
                    kwargs["save_primal"] = True
                if "rank" in accepted:
                    kwargs["rank"] = rank
            except (TypeError, ValueError):
                kwargs.update(save_primal=True, rank=rank)
            final_res = f.calculate(dual_val=last_x, **kwargs)

        if logging:
            log_objective_result(final_res, step=self.max_iter)
        if self.gamma is not None:
            self.gamma = float(gamma)

        return SolverResult(
            dual_val=y,
            dual_objective=float(dual_obj),
            objective_result=final_res,
            dual_objective_log=dual_obj_log,
            step_size_log=step_size_log,
        )

    def _log_row(self, it: int, row: np.ndarray, per_iter: ObjectiveResult) -> None:
        """The per-iteration MLflow metrics of one fetched metrics row."""
        metrics = {"step_size": float(row[1]), "dual_objective": float(row[0])}
        if self.gamma is not None:
            metrics["gamma"] = float(row[3])
        log_metrics(metrics, step=it)
        log_objective_result(per_iter, step=it)

    @staticmethod
    def _row_to_result(row: np.ndarray, fields_present: dict) -> ObjectiveResult:
        def get(name):
            return np.float32(row[METRICS.index(name)]) if fields_present.get(name) else None

        return ObjectiveResult(
            dual_gradient=None,
            dual_objective=np.float32(row[0]),
            reg_penalty=get("reg_penalty"),
            dual_val_times_grad=get("dual_val_times_grad"),
            max_pos_slack=get("max_pos_slack"),
            sum_pos_slack=get("sum_pos_slack"),
        )
