"""Dual-vector checkpoints for warm starts (``dualip_tpu/checkpoint.py``).

A checkpoint is an ``.npz`` with the dual and, optionally, the step-size
window, so a resumed solve re-enters the secant step-size regime at once.
``load_dual`` also reads a plain ``np.save``'d dual and a torch-saved dual
tensor (``torch.save(dual, path)``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from dualip_tpu_torch.optimizers.agd_utils import StepSizeState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_dual(path: str, dual_val, step_size_state: Optional[StepSizeState] = None) -> None:
    arrays = {"dual_val": _np(dual_val)}
    if step_size_state is not None:
        arrays["grad_hist"] = _np(step_size_state.grad_hist)
        arrays["dual_hist"] = _np(step_size_state.dual_hist)
        arrays["count"] = np.asarray(int(step_size_state.count))
    np.savez(Path(path), **arrays)


def load_dual(path: str) -> Tuple[np.ndarray, Optional[StepSizeState]]:
    """The dual as numpy and the step-size window (numpy arrays) if saved."""
    p = Path(path)
    if not p.exists() and p.with_suffix(p.suffix + ".npz").exists():
        p = p.with_suffix(p.suffix + ".npz")
    if p.suffix in (".pt", ".pth"):
        return _load_torch_dual(p), None
    try:
        loaded = np.load(p)
    except (ValueError, OSError) as np_err:
        if isinstance(np_err, FileNotFoundError):
            raise
        return _load_torch_dual(p), None  # not a numpy file: torch's pickle format
    if isinstance(loaded, np.ndarray):
        return loaded, None
    with loaded as data:
        if "dual_val" not in data.files:
            return _load_torch_dual(p), None  # torch.save zips open as npz too
        dual = data["dual_val"]
        state = None
        if "grad_hist" in data:
            state = StepSizeState(
                grad_hist=data["grad_hist"],
                dual_hist=data["dual_hist"],
                count=int(data["count"]),
            )
    return dual, state


def _load_torch_dual(p: Path) -> np.ndarray:
    obj = torch.load(p, map_location="cpu", weights_only=True)
    if not isinstance(obj, torch.Tensor):
        raise ValueError(f"{p}: expected a torch tensor dual, got {type(obj).__name__}")
    return obj.detach().numpy()
