"""Lipschitz-history step size (``dualip_tpu/optimizers/agd_utils.py``).

A window of the last ``H`` (gradient, dual) pairs; pairwise secant estimates
``L_i = ||g_{i+1}-g_i|| / ||d_{i+1}-d_i||``; step = ``min(1/max_i L_i,
max_step_size)``, ``initial_step_size`` until the window is full or when the
estimate is NaN/Inf, and ``max_step_size`` when the max estimate is zero.

The window is an ``(H, m)`` tensor pair and the count of valid rows a 0-d
int32 tensor, all on the device, as in the JAX package: the step size is
chosen with ``torch.where`` and never synchronises with the host, so an
iteration can be captured in a CUDA graph (``optimizers/agd.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

DEFAULT_HISTORY_LENGTH = 15


class StepSizeState(NamedTuple):
    """``grad_hist``/``dual_hist``: the last H pairs, oldest first; ``count``:
    the number of valid trailing rows (saturates at H), a 0-d int32 tensor
    (an ``int`` is taken too)."""

    grad_hist: torch.Tensor  # (H, m)
    dual_hist: torch.Tensor  # (H, m)
    count: torch.Tensor  # () int32


def init_step_size_state(
    m: int, history_length: int = DEFAULT_HISTORY_LENGTH, dtype=torch.float32, device=None
) -> StepSizeState:
    return StepSizeState(
        grad_hist=torch.zeros((history_length, m), dtype=dtype, device=device),
        dual_hist=torch.zeros((history_length, m), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def norm_of_difference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L2 norm of ``x - y``."""
    return torch.linalg.vector_norm(x - y)


def estimate_lipschitz_constant(grad_one, grad_two, dual_one, dual_two) -> torch.Tensor:
    """Secant Lipschitz estimate ``||g1 - g2|| / ||d1 - d2||``."""
    return norm_of_difference(grad_one, grad_two) / norm_of_difference(dual_one, dual_two)


def calculate_step_size(
    dual_grad: torch.Tensor,
    dual_val: torch.Tensor,
    state: StepSizeState,
    initial_step_size: float,
    max_step_size: torch.Tensor,
) -> Tuple[torch.Tensor, StepSizeState]:
    """Push the new (grad, dual) pair; return (step_size, new_state)."""
    H = state.grad_hist.shape[0]
    grad_hist = torch.cat([state.grad_hist[1:], dual_grad[None].to(state.grad_hist.dtype)], dim=0)
    dual_hist = torch.cat([state.dual_hist[1:], dual_val[None].to(state.dual_hist.dtype)], dim=0)
    count = torch.clamp_max(torch.as_tensor(state.count, dtype=torch.int32, device=dual_grad.device) + 1, H)

    dg = torch.linalg.vector_norm(grad_hist[1:] - grad_hist[:-1], dim=1)
    dd = torch.linalg.vector_norm(dual_hist[1:] - dual_hist[:-1], dim=1)
    lipschitz = dg / dd  # inf where dd == 0

    l_max = torch.amax(lipschitz)
    bad = torch.isnan(l_max) | torch.isinf(l_max)
    max_step_size = max_step_size.to(l_max.dtype)
    candidate = torch.where(l_max != 0, 1.0 / l_max, max_step_size)
    full_step = torch.minimum(candidate, max_step_size)

    # the initial step until the window is full, or when the estimate blew up
    initial = torch.full((), initial_step_size, dtype=full_step.dtype, device=full_step.device)
    step = torch.where((count < H) | bad, initial, full_step)
    return step, StepSizeState(grad_hist=grad_hist, dual_hist=dual_hist, count=count)
