"""Projection registry and map schema (``dualip_tpu/projections/base.py``).

Every operator's ``__call__`` projects each vector along the LAST axis of a
``(..., L)`` tensor of per-entity blocks, branch-free, so one call covers a
whole tile.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Union

import torch


@dataclass
class ProjectionEntry:
    """One entry of a projection map; ``indices`` are global column ids."""

    proj_type: str = ""
    proj_params: dict = field(default_factory=dict)
    indices: list = field(default_factory=list)


class ProjectionOperator(ABC):
    """Operators keep static Python state from ``__init__`` and project along
    the last axis in ``__call__``."""

    @abstractmethod
    def __init__(self, **params):
        ...

    @abstractmethod
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ...


_registry: Dict[str, type] = {}


def register(name: str):
    """Class decorator registering a projection under ``name``."""

    def decorator(cls):
        _registry[name] = cls
        return cls

    return decorator


def project(name: str, **params) -> ProjectionOperator:
    """Instantiate a projection operator by registry name."""
    if name not in _registry:
        raise ValueError(f"Unknown projection operator '{name}'")
    return _registry[name](**params)


def registered_projections() -> List[str]:
    return sorted(_registry)


def create_projection_map(
    proj_type: str,
    proj_params: Dict[str, float],
    num_indices: int,
    indices: Union[List[int], None] = None,
    key_prefix: str = "",
) -> Dict[str, ProjectionEntry]:
    """Single-entry projection map keyed ``f"{prefix}{type}_{param}_{value}..."``
    with params sorted by name."""
    if indices is None:
        indices = list(range(num_indices))

    param_str = "_".join(f"{k}_{v}" for k, v in sorted(proj_params.items()))
    key = f"{key_prefix}{proj_type}_{param_str}" if key_prefix else f"{proj_type}_{param_str}"

    return {key: ProjectionEntry(proj_type=proj_type, proj_params=proj_params, indices=indices)}
