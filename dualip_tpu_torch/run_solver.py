"""Solver entry point (``dualip_tpu/run_solver.py``).

``run_solver(input_args, solver_args, compute_args, objective_args,
mlflow_config)`` opens the MLflow run (a no-op without mlflow) and logs the
hyperparameters, builds the objective on ``compute_args.host_device``
(``cuda`` unless the caller asks for ``cpu``), warm-starts from
``initial_dual_path`` if given, and runs the AGD maximizer.

``compute_device_num > 1`` runs the entity-sharded solve: every rank (one
process each, in an initialised ``torch.distributed`` group of that many
ranks) calls ``run_solver`` with the same arguments; the objective keeps the
rank's shard over ``parallel.default_mesh`` (``cuda:{LOCAL_RANK}``, or
``host_device`` when it names the CPU or one card), and every rank returns
the same result.  MLflow logs on rank 0 only.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Optional

import numpy as np
import torch

from dualip_tpu_torch.checkpoint import load_dual
from dualip_tpu_torch.objectives.base import BaseInputArgs
from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.parallel.mesh import EntityMesh, is_rank_zero
from dualip_tpu_torch.types import ComputeArgs, ObjectiveArgs, SolverArgs, SolverResult, resolve_device
from dualip_tpu_torch.utils.mlflow_utils import MLflowConfig, log_hyperparameters, mlflow_run_context


def transfer_tensors_to_device(input_args: BaseInputArgs, device: str) -> BaseInputArgs:
    """API-parity shim: a field-for-field copy of ``input_args``.  Objectives
    place their own tensors on their device at construction."""
    del device
    return type(input_args)(**{f.name: getattr(input_args, f.name) for f in fields(input_args)})


_OBJECTIVE_REGISTRY: dict = {}


def register_objective(name: str):
    """Register a custom objective factory under ``ObjectiveArgs.objective_type``.

    The factory is called as ``factory(input_args, solver_args=...,
    compute_args=..., mesh=..., **objective_kwargs)`` (``mesh``: the rank's
    ``EntityMesh`` when ``compute_device_num > 1``, else ``None``) and returns
    an objective exposing ``equality_mask``, ``params`` and
    ``calculate_traceable``, and ``mesh`` when it is sharded (the solve's
    device is then ``mesh.device``); ``input_args`` carries a ``b_vec`` whose
    length is the dual dimension.  Built-in names cannot be overridden.
    """

    def deco(factory):
        if name in ("matching", "miplib2017"):
            raise ValueError(f"{name!r} is a built-in objective type")
        _OBJECTIVE_REGISTRY[name] = factory
        return factory

    return deco


def _mesh(compute_args: ComputeArgs):
    """``default_mesh(compute_device_num)`` for a sharded solve, else ``None``.
    The rank's device: ``host_device`` when it names the CPU or one card,
    else ``cuda:{LOCAL_RANK}``."""
    if compute_args.compute_device_num <= 1:
        return None
    from dualip_tpu_torch.parallel.mesh import default_mesh

    dev = torch.device(compute_args.host_device)
    return default_mesh(compute_args.compute_device_num,
                        device=dev if dev.type != "cuda" or dev.index is not None else None)


def build_objective(
    input_args: BaseInputArgs,
    solver_args: SolverArgs,
    compute_args: ComputeArgs,
    objective_args: ObjectiveArgs,
):
    objective_type = objective_args.objective_type
    objective_kwargs = objective_args.objective_kwargs or {}
    mesh = _mesh(compute_args)

    if objective_type in _OBJECTIVE_REGISTRY:
        if objective_args.use_jacobi_precondition:
            raise ValueError(
                "use_jacobi_precondition is not forwarded to registered objectives; "
                "handle preconditioning inside the factory"
            )
        kwargs = dict(objective_kwargs)
        kwargs.setdefault("mesh", mesh)  # a mesh in objective_kwargs is passed as it is
        return _OBJECTIVE_REGISTRY[objective_type](
            input_args, solver_args=solver_args, compute_args=compute_args, **kwargs)
    if objective_type == "miplib2017":
        from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction

        kwargs = dict(objective_kwargs)
        if objective_args.use_jacobi_precondition:
            kwargs.setdefault("use_jacobi_precondition", True)
        _place(kwargs, mesh, compute_args)
        return MIPLIB2017ObjectiveFunction(miplib_input_args=input_args, **kwargs)
    if objective_type == "matching":
        kwargs = dict(objective_kwargs)
        _place(kwargs, mesh, compute_args)
        return MatchingSolverDualObjectiveFunction(
            matching_input_args=input_args, gamma=solver_args.gamma, **kwargs
        )
    raise ValueError(
        f"Objective type {objective_type} not supported (registered: "
        f"{['matching', 'miplib2017'] + sorted(_OBJECTIVE_REGISTRY)})"
    )


def _place(kwargs: dict, mesh, compute_args: ComputeArgs) -> None:
    """The built-in objectives' placement: the mesh (its device) or
    ``host_device``."""
    if mesh is not None:
        kwargs.setdefault("mesh", mesh)
    elif kwargs.get("mesh") is None:
        kwargs.setdefault("device", compute_args.host_device)


def run_solver(
    input_args: BaseInputArgs,
    solver_args: SolverArgs,
    compute_args: ComputeArgs,
    objective_args: ObjectiveArgs,
    mlflow_config: Optional[MLflowConfig] = None,
) -> SolverResult:
    """Run one LP solve, logged to MLflow when ``mlflow_config`` enables it
    and mlflow is installed."""
    if mlflow_config is None or not is_rank_zero():
        mlflow_config = MLflowConfig(enabled=False)

    with mlflow_run_context(mlflow_config):
        if mlflow_config.enabled and mlflow_config.log_hyperparameters:
            log_hyperparameters({"solver": solver_args.__dict__, "objective": objective_args.__dict__})
        return _solve(input_args, solver_args, compute_args, objective_args)


def _solve(input_args, solver_args, compute_args, objective_args) -> SolverResult:
    input_args = transfer_tensors_to_device(input_args, compute_args.host_device)
    objective = build_objective(input_args, solver_args, compute_args, objective_args)
    mesh = getattr(objective, "mesh", None)
    device = mesh.device if isinstance(mesh, EntityMesh) else resolve_device(compute_args.host_device)

    solver = AcceleratedGradientDescent(
        initial_step_size=solver_args.initial_step_size,
        max_iter=solver_args.max_iter,
        max_step_size=solver_args.max_step_size,
        gamma=solver_args.gamma,
        gamma_decay_type=solver_args.gamma_decay_type,
        gamma_decay_params=solver_args.gamma_decay_params,
        save_primal=solver_args.save_primal,
        restart=solver_args.restart,
        restart_min_spacing=solver_args.restart_min_spacing,
        launch_chunk=solver_args.launch_chunk,
    )

    ss_state = None
    if solver_args.initial_dual_path is not None:
        dual0, ss_state = load_dual(solver_args.initial_dual_path)
        # a float64 dual solves in float32, as in the JAX package (x64 off)
        initial_dual = torch.as_tensor(np.asarray(dual0, dtype=np.float32), device=device)
    else:
        initial_dual = torch.zeros(np.asarray(input_args.b_vec).shape[0], dtype=torch.float32, device=device)

    solver_result = solver.maximize(objective, initial_dual, initial_step_size_state=ss_state)

    if getattr(objective, "use_jacobi_precondition", False):
        inv_dual, inv_grad = objective.invert_jacobi_precondition(
            solver_result.dual_val, solver_result.objective_result.dual_gradient
        )
        solver_result.dual_val = inv_dual
        solver_result.objective_result.dual_gradient = inv_grad
    return solver_result
