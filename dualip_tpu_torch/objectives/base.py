"""Objective-function base classes (``dualip_tpu/objectives/base.py``).

The optimizer consumes ``calculate_traceable(params, dual_val, gamma)``; the
name is kept from the JAX package so both objectives expose one contract.
Here it is an eager evaluation on tensors that must not synchronise with
the host (no ``.item()``), so a solve can queue iterations back to back.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Optional

import torch

from dualip_tpu_torch.types import ObjectiveResult


@dataclass
class BaseInputArgs(ABC):
    """Base for objective input dataclasses."""

    def __post_init__(self):
        pass


class BaseObjective(ABC):
    """Base objective."""

    equality_mask: Optional[torch.Tensor] = None

    @property
    def params(self) -> Any:
        """Problem data passed to ``calculate_traceable``."""
        return ()

    @abstractmethod
    def calculate_traceable(self, params: Any, dual_val: torch.Tensor, gamma) -> ObjectiveResult:
        """Gradient/objective at ``dual_val`` without a host sync."""
        ...

    def calculate(
        self,
        dual_val: torch.Tensor,
        gamma: Optional[float] = None,
        save_primal: bool = False,
        rank: int = 0,
        **kwargs,
    ) -> ObjectiveResult:
        del save_primal, rank, kwargs
        return self.calculate_traceable(self.params, dual_val, gamma)
