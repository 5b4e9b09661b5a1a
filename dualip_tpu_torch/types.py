"""Config and result types for the PyTorch/CUDA port of the solver.

Mirrors ``dualip_tpu/types.py``: the same dataclass names and fields, with
``torch.Tensor`` in place of ``jax.Array``.  ``resolve_device`` is the one
place that turns a caller's device choice into a ``torch.device``: entry
points run on ``cuda`` unless the caller asks for the CPU, and a missing
CUDA device is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Literal, Optional, Union

import torch

Tensor = torch.Tensor


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or host_device='cpu') "
            "to run on the CPU"
        )
    return dev


@dataclass
class SolverArgs:
    """Solver hyper-parameters (``dualip_tpu/types.py:20``).

    ``launch_chunk`` is accepted so configurations carry over unchanged; the
    eager loop here launches per iteration anyway, so it has no effect.
    """

    max_iter: int = 10000
    initial_step_size: float = 1e-5
    gamma: float = 1e-3
    max_step_size: float = 0.1
    initial_dual_path: Optional[str] = None
    gamma_decay_type: Optional[Literal["step"]] = None
    gamma_decay_params: Optional[dict] = None
    save_primal: bool = False
    restart: Optional[Literal["gradient", "function"]] = None
    restart_min_spacing: int = 50
    launch_chunk: int = 0


@dataclass
class ComputeArgs:
    """Compute placement (``dualip_tpu/types.py:48``).

    ``host_device`` is the torch device the solve runs on (``"cuda"`` by
    default, ``"cpu"`` on request).  ``compute_device_num > 1`` is the
    distributed slice of the port, not yet ported.
    """

    host_device: str = "cuda"
    compute_device_num: int = 1


@dataclass
class ObjectiveArgs:
    """Objective selection (``dualip_tpu/types.py:62``)."""

    objective_type: Literal["miplib2017", "matching"] = "matching"
    use_jacobi_precondition: bool = False
    objective_kwargs: Optional[Dict[str, Any]] = None


@dataclass
class ObjectiveResult:
    """Per-evaluation outputs of an objective (``dualip_tpu/types.py:71``).

    Fields are 0-d or 1-d tensors on the solve's device; ``primal_var`` is a
    host numpy array in flat CSC order (``save_primal``).
    """

    dual_gradient: Tensor
    dual_objective: Tensor
    reg_penalty: Optional[Tensor] = None
    primal_objective: Optional[Tensor] = None
    primal_var: Optional[Any] = None
    dual_val_times_grad: Optional[Tensor] = None
    max_pos_slack: Optional[Tensor] = None
    sum_pos_slack: Optional[Tensor] = None


@dataclass
class SolverResult:
    """Final solver output (``dualip_tpu/types.py:113``)."""

    dual_val: Tensor
    dual_objective: float
    objective_result: ObjectiveResult
    dual_objective_log: List[float] = field(default_factory=list)
    step_size_log: List[float] = field(default_factory=list)
