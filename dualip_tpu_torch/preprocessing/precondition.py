"""Jacobi (row-norm) preconditioning (``dualip_tpu/preprocessing/precondition.py``),
numpy only.

Scales each constraint row of A (and b) by the reciprocal of its L2 norm;
optionally persists the norms so the solved dual can be mapped back to the
original scaling.  Operates on host-side ``CSCMatrix``/numpy inputs before
tile construction (functional — returns new values, unlike the reference's
in-place mutation, ``precondition.py:8-28``)."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np

from dualip_tpu_torch.sparse.csc import CSCMatrix, left_multiply_sparse, row_norms_csc


def jacobi_precondition(
    A: CSCMatrix, b: np.ndarray, norms_save_path: str = None
) -> Tuple[CSCMatrix, np.ndarray, np.ndarray]:
    """Return (A_scaled, b_scaled, row_norms); rows with zero norm are left
    unscaled.  If ``norms_save_path`` is given, the norms are saved (.npy)
    for later inversion (reference ``precondition.py:8-28``)."""
    row_norms = row_norms_csc(A)
    safe = np.where(row_norms == 0, 1.0, row_norms)
    reciprocal = (1.0 / safe).astype(A.data.dtype)

    if norms_save_path:
        np.save(Path(norms_save_path).with_suffix(".npy"), row_norms)

    A_scaled = left_multiply_sparse(reciprocal, A)
    b_scaled = np.asarray(b) * reciprocal
    return A_scaled, b_scaled, row_norms


def jacobi_invert_precondition(
    dual_val: np.ndarray, norms_path_or_tensor: Union[str, np.ndarray]
) -> np.ndarray:
    """Map a dual from the preconditioned space back to the original scaling:
    λ_orig = diag(1/row_norms) λ' (reference ``precondition.py:31-60``)."""
    if isinstance(norms_path_or_tensor, (str, Path)):
        row_norms = np.load(Path(norms_path_or_tensor).with_suffix(".npy"))
    else:
        row_norms = np.asarray(norms_path_or_tensor)
    safe = np.where(row_norms == 0, 1.0, row_norms)
    return (1.0 / safe) * np.asarray(dual_val)
